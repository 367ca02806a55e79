"""The port's 5-point solver, essential-matrix RANSAC and relative-pose
estimators against the JAX package's on the CPU.

- `essential_5pt` on 256 exact minimal samples of random scenes. The
  nullspace basis of the 5 x 9 system is unique only up to a rotation, and
  torch's SVD picks another one than JAX's: another basis gives the same
  solutions but other roots of det M(z), so the 512-point sign scan merges
  other near-double roots. Compared are therefore the solution sets (each
  E normalized, matched against +-E, order ignored) of the candidates that
  solve the sample (epipolar, det and trace residuals below 1e-4). Measured
  at this seed: the root counts differ in 21 of 256 samples (8.2%), the
  solving sets are equal within 1e-3 in 216 (84%), one holds the other in
  254 (99.2%), and each package finds the true E in 250. The stages on the
  same basis (constraint matrix, roots, Gauss-Newton polish) match JAX's.
- `ransac_essential` (5pt and 8pt) on correspondences from a known pose
  with outliers, at the same seed and `n_iters`. 5pt at 30% outliers:
  success equal, inlier masks at least 99% equal, R and t within 0.1
  degrees of JAX's. At 50% outliers few of the 128 minimal sets are clean,
  and the two packages' candidate sets (other bases, above) can crown
  another hypothesis among near-equal counts: measured 126 of 128 mask
  entries equal and 0.23 degrees between the rotations in one of the 3
  trials, so there masks at least 95% equal and R, t within 0.5 degrees.
  8pt: each hypothesis is the smallest eigenvector of the float32 normal
  matrix A^T A of 8 rows, whose squared condition number leaves it to
  rounding; on the same minimal sets torch's and JAX's `eigh` give
  hypotheses that differ by 2e-3 (median, 0.04 at the 90th percentile), so
  the outcome is compared: success equal, inlier masks at least 80% equal,
  both poses within 1 degree (R) and 2 degrees (t) of the truth.
- The `xla_ransac` (`device="cpu"`) and `opencv` relative-pose estimators
  against JAX's on the same data: the pose within 0.1 degrees, inliers at
  least 99% equal (opencv: equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import wrappers as jw
from gluefactory_tpu.ops import essential5 as J5
from gluefactory_tpu.ops import ransac as jransac
from gluefactory_tpu.robust_estimators import load_estimator as jload
from gluefactory_tpu_torch.eval.utils import angle_error_mat_np, angle_error_vec_np
from gluefactory_tpu_torch.geometry import wrappers as tw
from gluefactory_tpu_torch.ops import essential5 as T5
from gluefactory_tpu_torch.ops import ransac as transac
from gluefactory_tpu_torch.robust_estimators import load_estimator as tload
from gluefactory_tpu_torch.scripts_dev.posed_scenes import synthetic_correspondences


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file's tests and fixtures: the suite runs 6
    workers on the host's cores, and torch's default pool oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_SAMPLES = 256
SET_TOL = 1e-3  # normalized E, matched against +-E
SOLVES = 1e-4  # epipolar, det and trace residuals of a solving candidate


def _minimal_samples(seed=0, n=N_SAMPLES):
    rng = np.random.default_rng(seed)
    scenes = [synthetic_correspondences(rng, 5) for _ in range(n)]
    return (np.stack([s[0] for s in scenes]), np.stack([s[1] for s in scenes]),
            np.stack([s[4] for s in scenes]))


def _residual(E, p0, p1):
    h0, h1 = np.c_[p0, np.ones(len(p0))], np.c_[p1, np.ones(len(p1))]
    epi = np.abs(np.einsum("ni,ij,nj->n", h1, E, h0)).max()
    return max(epi, abs(np.linalg.det(E)), np.abs(2 * E @ E.T @ E - np.trace(E @ E.T) * E).max())


def _dist(E, others):
    return min([min(np.abs(E - F).max(), np.abs(E + F).max()) for F in others] + [np.inf])


def _same_set(a, b):
    return len(a) == len(b) and all(_dist(E, b) < SET_TOL for E in a)


def test_essential_5pt_solution_sets():
    p0, p1, E_gt = _minimal_samples()
    Et = T5.essential_5pt(torch.from_numpy(p0), torch.from_numpy(p1)).numpy()
    Ej = np.asarray(jax.jit(J5.essential_5pt)(jnp.asarray(p0), jnp.asarray(p1)))
    assert Et.shape == Ej.shape == (N_SAMPLES, 10, 3, 3)
    counts_differ = equal = nested = found_t = found_j = 0
    residuals = []
    for b in range(N_SAMPLES):
        finite_t = [E for E in Et[b] if np.isfinite(E).all()]
        finite_j = [E for E in Ej[b] if np.isfinite(E).all()]
        counts_differ += len(finite_t) != len(finite_j)
        residuals += [_residual(E, p0[b], p1[b]) for E in finite_t]
        for E in finite_t:  # unit norm, as JAX's
            assert abs(np.linalg.norm(E) - 1) < 1e-5
        solve_t = [E for E in finite_t if _residual(E, p0[b], p1[b]) < SOLVES]
        solve_j = [E for E in finite_j if _residual(E, p0[b], p1[b]) < SOLVES]
        equal += _same_set(solve_t, solve_j)
        small, big = sorted([solve_t, solve_j], key=len)
        nested += all(_dist(E, big) < SET_TOL for E in small)
        found_t += _dist(E_gt[b], solve_t) < SET_TOL
        found_j += _dist(E_gt[b], solve_j) < SET_TOL
    # measured: 21 / 256 counts differ, 216 equal, 254 nested, 250 / 250 found
    assert counts_differ <= 0.12 * N_SAMPLES, counts_differ
    assert equal >= 0.8 * N_SAMPLES, equal
    assert nested >= 0.98 * N_SAMPLES, nested
    assert found_t >= 0.95 * N_SAMPLES and abs(found_t - found_j) <= 0.02 * N_SAMPLES, (found_t, found_j)
    # det E ~ 0 and the trace constraint (and the epipolar rows) on 99% of
    # the candidates; the rest are roots the scan could not separate
    assert np.mean(np.array(residuals) < SOLVES) >= 0.99


def test_essential_5pt_stages_on_one_basis():
    """On the same basis: the constraint matrix within 1e-5 of its largest
    entry, the same root slots with roots within 2e-5 in atan(z), and the
    polish on the same start within 1e-3 relative (1e-4 absolute)."""
    p0, p1, _ = _minimal_samples(1, 64)
    x0, y0, x1, y1 = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, np.ones_like(x0)], -1)
    basis = torch.linalg.svd(torch.from_numpy(A), full_matrices=True).Vh[:, 5:]
    Mt = T5._constraint_matrix(basis)
    Mj = np.asarray(jax.jit(J5._constraint_matrix)(jnp.asarray(basis.numpy())))
    np.testing.assert_allclose(Mt.numpy(), Mj, atol=1e-5 * np.abs(Mj).max(), rtol=0)
    Mt = Mt / (torch.linalg.vector_norm(Mt, dim=-1, keepdim=True) + 1e-30)
    Mj = jnp.asarray(Mt.numpy())
    Ms_t = T5._z_matrices(Mt)
    Ms_j = jax.jit(J5._z_matrices)(Mj)
    for k in range(4):
        np.testing.assert_array_equal(Ms_t[k].numpy(), np.asarray(Ms_j[k]))
    zt, vt = T5._real_roots(Ms_t)
    zj, vj = jax.jit(J5._real_roots)(Ms_j)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    zt, zj = zt.numpy(), np.asarray(zj)
    valid = np.asarray(vj)
    # the bisection runs in the angle theta = atan(z); near +-pi/2 a float32
    # theta step is a large step of z
    np.testing.assert_allclose(np.arctan(zt[valid]), np.arctan(zj[valid]), rtol=0, atol=2e-5)
    s = np.stack([np.full_like(zj, 0.1), np.full_like(zj, -0.2), np.where(valid, zj, 0.0)], -1)
    st = T5._polish(Mt, torch.from_numpy(s))
    sj = jax.jit(jax.vmap(jax.vmap(J5._polish, in_axes=(None, 0))))(Mj, jnp.asarray(s))
    ok = np.isfinite(np.asarray(sj)).all(-1) & (np.abs(np.asarray(sj)).max(-1) < 1e3)
    np.testing.assert_allclose(st.numpy()[ok], np.asarray(sj)[ok], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("solver,outliers,n_iters", [("5pt", 0.3, 64), ("5pt", 0.5, 128),
                                                     ("8pt", 0.1, 128)])
def test_ransac_essential_equals_jax(solver, outliers, n_iters):
    rng = np.random.default_rng(len(solver) + int(outliers * 10))
    for trial in range(3):
        p0, p1, R, t, _, _ = synthetic_correspondences(rng, 120, noise=1e-3, outliers=outliers)
        valid = np.ones(128, bool)
        valid[120:] = False  # padding, as the estimator's bucket
        p0, p1 = np.pad(p0, ((0, 8), (0, 0))), np.pad(p1, ((0, 8), (0, 0)))
        ot = transac.ransac_essential(torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid),
                                      4e-3, seed=trial, n_iters=n_iters, solver=solver)
        oj = jransac.ransac_essential(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), 4e-3,
                                      jax.random.key(trial), n_iters=n_iters, solver=solver)
        assert bool(ot["success"]) == bool(oj["success"])
        same = (ot["inliers"].numpy() == np.asarray(oj["inliers"])).mean()
        if solver == "5pt":
            min_same, max_angle = (0.99, 0.1) if outliers < 0.5 else (0.95, 0.5)
            assert same >= min_same
            assert angle_error_mat_np(ot["R"].numpy(), np.asarray(oj["R"])) < max_angle
            assert angle_error_vec_np(ot["t"].numpy(), np.asarray(oj["t"])) < max_angle
        else:
            assert same >= 0.8
            for Rx, tx in ((ot["R"].numpy(), ot["t"].numpy()), (np.asarray(oj["R"]), np.asarray(oj["t"]))):
                assert angle_error_mat_np(Rx, R) < 1 and angle_error_vec_np(tx, t) < 2
        for k in ("E", "R", "t"):
            assert ot[k].shape == tuple(np.asarray(oj[k]).shape)


def _pixel_matches(seed, n=90, outliers=0.25):
    """Matches in pixels of two cameras (SIMPLE_RADIAL-free pinholes) from a
    known pose, and both packages' cameras and GT pose."""
    rng = np.random.default_rng(seed)
    p0, p1, R, t, _, _ = synthetic_correspondences(rng, n, noise=3e-4, outliers=outliers)
    cams = [{"model": "PINHOLE", "width": 640, "height": 480, "params": [500.0, 510.0, 320.0, 240.0]},
            {"model": "SIMPLE_PINHOLE", "width": 640, "height": 480, "params": [480.0, 330.0, 235.0]}]
    tc = [tw.Camera.from_colmap(c) for c in cams]
    jc = [jw.Camera.from_colmap(c) for c in cams]
    k0 = np.asarray(jc[0].denormalize(p0[None]))[0]
    k1 = np.asarray(jc[1].denormalize(p1[None]))[0]
    return k0, k1, tc, jc, R, t


@pytest.mark.parametrize("name", ["xla_ransac", "opencv"])
def test_relative_pose_estimators_equal_jax(name):
    conf = {"ransac_th": 1.0, "device": "cpu"}
    est_t = tload("relative_pose", name)(conf)
    est_j = jload("relative_pose", name)({k: v for k, v in conf.items() if k != "device"})
    for seed in range(2):
        k0, k1, tc, jc, R, t = _pixel_matches(seed)
        got = est_t({"m_kpts0": k0, "m_kpts1": k1, "camera0": tc[0], "camera1": tc[1]})
        want = est_j({"m_kpts0": k0, "m_kpts1": k1, "camera0": jc[0], "camera1": jc[1]})
        assert got["success"] and want["success"]
        if name == "opencv":
            np.testing.assert_array_equal(got["inliers"], want["inliers"])
            np.testing.assert_array_equal(got["M_0to1"].R.numpy(), np.asarray(want["M_0to1"].R))
        else:
            assert (got["inliers"] == want["inliers"]).mean() >= 0.99
        assert angle_error_mat_np(got["M_0to1"].R.numpy(), np.asarray(want["M_0to1"].R)) < 0.1
        assert angle_error_vec_np(got["M_0to1"].t.numpy(), np.asarray(want["M_0to1"].t)) < 0.1
        assert angle_error_mat_np(got["M_0to1"].R.numpy(), R) < 2
    few = est_t({"m_kpts0": k0[:4], "m_kpts1": k1[:4], "camera0": tc[0], "camera1": tc[1]})
    assert not few["success"] and few["inliers"].shape == (4,)


def test_xla_ransac_defaults_to_the_card():
    est = tload("relative_pose", "xla_ransac")()
    assert est.conf.device == "cuda" and est.conf.n_iters == 512 and est.conf.solver == "5pt"
