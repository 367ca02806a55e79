"""The point and line homography RANSAC (`ops/ransac.ransac_homography_hybrid`)
and the `homography_est` estimator against the JAX package's, on seeded
correspondences: inlier points and segments under a homography with noise,
outliers of both kinds, padding. The same H within 1e-4 relative and the
same inlier masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops import ransac as jax_ransac
from gluefactory_tpu.robust_estimators import load_estimator as jax_load_estimator
from gluefactory_tpu_torch.ops import ransac
from gluefactory_tpu_torch.robust_estimators import load_estimator
from gluefactory_tpu_torch.robust_estimators.homography.homography_est import bucket_pad_lines
from gluefactory_tpu_torch.robust_estimators.homography.xla_ransac import bucket_pad


def _correspondences(seed, n_pts, n_lines, outliers=0.3):
    rng = np.random.default_rng(seed)
    H = np.eye(3)
    H[:2, :2] += rng.normal(scale=0.1, size=(2, 2))
    H[:2, 2] = rng.normal(scale=10, size=2)
    H[2, :2] = rng.normal(scale=1e-4, size=2)

    def warp(p):
        q = np.concatenate([p, np.ones_like(p[..., :1])], -1) @ H.T
        return q[..., :2] / q[..., 2:]

    p0 = rng.uniform(0, 640, (n_pts, 2))
    p1 = warp(p0) + rng.normal(scale=0.5, size=(n_pts, 2))
    bad = rng.random(n_pts) < outliers
    p1[bad] = rng.uniform(0, 640, (int(bad.sum()), 2))
    l0 = rng.uniform(0, 640, (n_lines, 2, 2))
    l1 = warp(l0) + rng.normal(scale=0.5, size=l0.shape)
    badl = rng.random(n_lines) < outliers
    l1[badl] = rng.uniform(0, 640, (int(badl.sum()), 2, 2))
    return (p0.astype(np.float32), p1.astype(np.float32), l0.astype(np.float32),
            l1.astype(np.float32))


@pytest.mark.parametrize("seed,n_pts,n_lines,th", [(0, 60, 20, 2.0), (1, 200, 50, 3.0),
                                                   (2, 24, 40, 2.0)])
def test_hybrid_ransac_equals_jax(seed, n_pts, n_lines, th):
    p0, p1, l0, l1 = _correspondences(seed, n_pts, n_lines)
    pp0, pp1, pv, n = bucket_pad(p0, p1)
    ll0, ll1, lv, nl = bucket_pad_lines(l0, l1)
    want = jax_ransac.ransac_homography_hybrid(*(jnp.asarray(a) for a in (pp0, pp1, pv, ll0, ll1, lv)),
                                               th, jax.random.key(seed), n_iters=256)
    got = ransac.ransac_homography_hybrid(*(torch.from_numpy(a) for a in (pp0, pp1, pv, ll0, ll1, lv)),
                                          th, seed=seed, n_iters=256)
    H, Hj = got["M_0to1"].numpy(), np.asarray(want["M_0to1"])
    np.testing.assert_allclose(H / H[2, 2], Hj / Hj[2, 2], rtol=1e-4, atol=1e-4 * np.abs(Hj).max())
    for k in ("inliers", "line_inliers"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int(got["num_inliers"]) == int(want["num_inliers"])
    assert bool(got["success"]) == bool(want["success"]) is True
    assert got["line_inliers"].sum() >= 0.5 * nl


def test_line_residuals_equal_jax():
    _, _, l0, l1 = _correspondences(3, 4, 16)
    H = np.eye(3, dtype=np.float32)
    H[0, 2], H[1, 0] = 3.0, 0.01
    want = jax_ransac._line_residuals(jnp.asarray(H), jnp.asarray(l0), jnp.asarray(l1))
    got = ransac._line_residuals(torch.from_numpy(H), torch.from_numpy(l0), torch.from_numpy(l1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_pts", [3, 40])
def test_homography_est_estimator_equals_jax(n_pts):
    p0, p1, l0, l1 = _correspondences(4, n_pts, 25)
    data = {"m_kpts0": p0, "m_kpts1": p1, "m_lines0": l0, "m_lines1": l1}
    want = jax_load_estimator("homography", "homography_est")({"ransac_th": 2.0})(data)
    got = load_estimator("homography", "homography_est")({"ransac_th": 2.0, "device": "cpu"})(data)
    assert set(got) == set(want) and got["success"] == want["success"]
    np.testing.assert_allclose(got["M_0to1"], want["M_0to1"], rtol=1e-4, atol=1e-4)
    for k in set(got) - {"M_0to1", "success"}:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
