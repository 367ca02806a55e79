"""The port's JAX PRNG, DLT, batched homography RANSAC and homography
estimators against the JAX package on the CPU, on the same numpy inputs.

Tolerances: the threefry bits and uniforms bit-equal; the Gumbel noise
within 2 float32 ulps of JAX's (each log taken in float64 and rounded, XLA's
float32 log is not correctly rounded); the minimal-set indices equal; the
DLT within 2e-5 of JAX's after the H[2,2] division (float32 eigh in another
LAPACK call order); RANSAC inliers equal and H within 1e-4 relative on
planted matches whose inliers lie at least 0.5 px inside the threshold.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry.homography import compute_homography_dlt as jax_dlt
from gluefactory_tpu.ops import ransac as jax_ransac
from gluefactory_tpu.robust_estimators import load_estimator as jax_load_estimator
from gluefactory_tpu_torch.geometry.homography import compute_homography_dlt
from gluefactory_tpu_torch.ops import ransac
from gluefactory_tpu_torch.robust_estimators import load_estimator
from gluefactory_tpu_torch.robust_estimators.homography.xla_ransac import bucket_pad
from gluefactory_tpu_torch.utils import threefry

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -3]
SHAPES = [(1,), (5,), (3, 7), (2, 3, 5), (1024, 64)]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_and_noise_equal_jax(seed):
    for shape in SHAPES:
        k = jax.random.key(seed)
        bits = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
        np.testing.assert_array_equal(threefry.random_bits(seed, shape).numpy(), bits)
        tiny = np.finfo(np.float32).tiny
        u = np.asarray(jax.random.uniform(k, shape, minval=tiny))
        np.testing.assert_array_equal(threefry.uniform(seed, shape).numpy(), u)
        g = np.asarray(jax.random.gumbel(k, shape))
        got = threefry.gumbel(seed, shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        ulp = np.spacing(np.maximum(np.abs(g), 1.0).astype(np.float32))
        assert (np.abs(got - g) <= 2 * ulp).all()


def test_threefry_seed_range():
    assert threefry.key(5) == (0, 5) and threefry.key(-1) == (0, 2**32 - 1)
    with pytest.raises(OverflowError):
        threefry.key(2**31)


@pytest.mark.parametrize("n_valid,size", [(64, 64), (37, 64), (100, 128), (700, 1024)])
@pytest.mark.parametrize("seed", [0, 3])
def test_minimal_sets_equal_jax(n_valid, size, seed):
    valid = np.zeros(size, bool)
    valid[:n_valid] = True
    want = np.asarray(jax_ransac._sample_minimal_sets(jax.random.key(seed), 1024, 4, size,
                                                       jnp.asarray(valid)))
    got = ransac.sample_minimal_sets(seed, 1024, 4, torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))
    assert (got < n_valid).all()


def _planted(seed, n=100, inlier_share=0.6, noise=0.3, th=3.0):
    """Matches under a known homography: inliers within `noise` px, outliers
    at least 2 th off in both images."""
    rng = np.random.default_rng(seed)
    H = np.array([[1.05, 0.04, 12.0], [-0.03, 0.97, -7.0], [2e-4, -1e-4, 1.0]])
    p0 = rng.uniform(0, 640, (n, 2))
    ph = np.c_[p0, np.ones(n)] @ H.T
    p1 = ph[:, :2] / ph[:, 2:]
    n_in = int(n * inlier_share)
    p1[:n_in] += rng.uniform(-noise, noise, (n_in, 2))
    off = rng.uniform(2 * th + 5, 80, (n - n_in, 2)) * rng.choice([-1, 1], (n - n_in, 2))
    p1[n_in:] += off
    perm = rng.permutation(n)
    return p0[perm].astype(np.float32), p1[perm].astype(np.float32), (perm < n_in)


def test_dlt_equals_jax():
    """Random 4-point sets, some ill-conditioned: float32 rounding moves
    both packages' H away from the float64 fit (by up to 1.5e-2 relative
    here, a matrix's largest entry), so the port's gaps to it are held to
    twice JAX's, at the median and at the largest, and the port to JAX
    within 1e-4 at the median. A weighted fit on 100 points:
    within 2e-5 of JAX."""
    rng = np.random.default_rng(0)
    p0 = rng.uniform(0, 500, (64, 4, 2)).astype(np.float32)
    p1 = (p0 + rng.normal(0, 20, p0.shape)).astype(np.float32)
    want = np.asarray(jax_dlt(jnp.asarray(p0), jnp.asarray(p1)))
    got = compute_homography_dlt(torch.from_numpy(p0), torch.from_numpy(p1)).numpy()
    exact = compute_homography_dlt(torch.from_numpy(p0).double(), torch.from_numpy(p1).double()).numpy()
    scale = np.abs(exact).max(axis=(1, 2))
    port_gap = np.abs(got - exact).max(axis=(1, 2)) / scale
    jax_gap = np.abs(want - exact).max(axis=(1, 2)) / scale
    assert np.median(port_gap) <= 2 * np.median(jax_gap)
    assert port_gap.max() <= 2 * jax_gap.max()
    assert np.median(np.abs(got - want).max(axis=(1, 2)) / scale) <= 1e-4
    q0, q1, _ = _planted(1)
    w = rng.uniform(0, 1, q0.shape[0]).astype(np.float32)
    want = np.asarray(jax_dlt(jnp.asarray(q0[None]), jnp.asarray(q1[None]), jnp.asarray(w[None])))
    got = compute_homography_dlt(torch.from_numpy(q0[None]), torch.from_numpy(q1[None]),
                                 torch.from_numpy(w[None])).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_dlt_non_finite_input_gives_nan():
    p = torch.zeros(3, 4, 2)
    p[1, 0, 0] = float("nan")
    p[0] = torch.tensor([[0.0, 0], [1, 0], [1, 1], [0, 1]])
    p[2] = p[0] * 3
    H = compute_homography_dlt(p, p + 1)
    assert torch.isnan(H[1]).all()
    assert torch.isfinite(H[0]).all() and torch.isfinite(H[2]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_homography_equals_jax(seed):
    p0, p1, truth = _planted(seed)
    a0, a1, valid, n = bucket_pad(p0, p1)
    th = 3.0
    want = jax_ransac.ransac_homography(a0, a1, valid, th, jax.random.key(seed), n_iters=1024)
    got = ransac.ransac_homography(torch.from_numpy(a0), torch.from_numpy(a1),
                                   torch.from_numpy(valid), th, seed=seed, n_iters=1024)
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    np.testing.assert_array_equal(got["inliers"].numpy()[:n], truth)
    H, Hj = got["M_0to1"].numpy(), np.asarray(want["M_0to1"])
    np.testing.assert_allclose(H, Hj, atol=1e-4 * np.abs(Hj).max())
    assert int(got["num_inliers"]) == int(want["num_inliers"]) and bool(got["success"])
    assert got["M_0to1"].device.type == "cpu"  # the inputs' device


def test_ransac_degenerate_input_fails_cleanly():
    """All points on one spot: every hypothesis degenerate, no success and
    no error."""
    p = torch.zeros(64, 2)
    valid = torch.zeros(64, dtype=torch.bool)
    valid[:10] = True
    out = ransac.ransac_homography(p, p, valid, 3.0)
    assert out["inliers"].shape == (64,)
    want = jax_ransac.ransac_homography(np.zeros((64, 2), np.float32), np.zeros((64, 2), np.float32),
                                        valid.numpy(), 3.0, jax.random.key(0))
    assert bool(out["success"]) == bool(want["success"])


@pytest.mark.parametrize("n", [3, 20, 64, 65, 300])
def test_xla_ransac_estimator_equals_jax(n):
    p0, p1, _ = _planted(n, n=n)
    conf = {"ransac_th": 2.0}
    want = jax_load_estimator("homography", "xla_ransac")(conf)({"m_kpts0": p0, "m_kpts1": p1})
    got = load_estimator("homography", "xla_ransac")({**conf, "device": "cpu"})(
        {"m_kpts0": p0, "m_kpts1": p1})
    assert got["success"] == want["success"]
    assert got["inliers"].shape == (n,) and got["inliers"].dtype == bool
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    np.testing.assert_allclose(got["M_0to1"], want["M_0to1"],
                               atol=1e-4 * np.abs(want["M_0to1"]).max())
    assert bucket_pad(p0, p1)[2].shape[0] == max(64, 1 << int(np.ceil(np.log2(n))))


def test_opencv_estimator_equals_jax():
    p0, p1, _ = _planted(4)
    conf = {"ransac_th": 2.0}
    want = jax_load_estimator("homography", "opencv")(conf)({"m_kpts0": p0, "m_kpts1": p1})
    got = load_estimator("homography", "opencv")(conf)({"m_kpts0": p0, "m_kpts1": p1})
    assert got["success"] and want["success"]
    np.testing.assert_array_equal(got["M_0to1"], want["M_0to1"])
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    few = load_estimator("homography", "opencv")(conf)({"m_kpts0": p0[:3], "m_kpts1": p1[:3]})
    assert not few["success"] and few["inliers"].shape == (3,)


def test_opencv_estimator_without_cv2_raises():
    code = """
import sys
sys.modules["cv2"] = None
from gluefactory_tpu_torch.robust_estimators import load_estimator
cls = load_estimator("homography", "opencv")
try:
    cls({})
except ImportError as e:
    assert "cv2" in str(e) and "xla_ransac" in str(e), e
else:
    raise AssertionError("no ImportError")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_estimator_conf_merge():
    est = load_estimator("homography", "xla_ransac")({"ransac_th": 0.5})
    assert est.conf.ransac_th == 0.5 and est.conf.n_iters == 1024 and est.conf.device == "cuda"
    assert est.conf.name is None and est.conf.seed == 0
    with pytest.raises(ModuleNotFoundError):
        load_estimator("homography", "no_such_estimator")


def test_ransac_timing_tool_on_cpu():
    """The stage-timing tool runs every stage on the CPU and reports no
    time there."""
    from gluefactory_tpu_torch.scripts_dev import ransac_timing

    res = ransac_timing.main(device="cpu", buckets=(64,))
    assert set(res["buckets"][64]) == {"call", "noise", "minimal_sets", "dlt_1024", "scoring", "refit"}
    assert all(v is None for v in res["buckets"][64].values())
    assert set(res["solvers"]) == {"eigh_9x9", "svd_8x9", "solve_8x8"} and res["card"] == "cpu"
