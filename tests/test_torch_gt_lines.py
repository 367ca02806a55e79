"""The port's line ground truth (`geometry/gt_lines.py`) against the JAX
package's, as integers that must be equal: the auction (random scores,
scores with ties, rows with every pair forbidden, the `max_iters` cap), the
greedy assignment, the homography line GT and `homography_matcher` with
`use_lines`. (`depth_matcher` with `use_lines`, hence
`gt_line_matches_from_pose_depth`, is held to JAX's in
`test_torch_depth_matcher.py`.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import gt_lines as jgt
from gluefactory_tpu.models.matchers.homography_matcher import HomographyMatcher as JaxHM
from gluefactory_tpu_torch.geometry import gt_lines
from gluefactory_tpu_torch.models import get_model


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The auction is a loop of many tiny tensor ops: one intra-op thread a
    test worker (others would only contend with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scores(case, rng, B=3, M=12, N=10):
    if case == "random":
        s = rng.uniform(0, 1, (B, M, N))
    elif case == "ties":
        s = rng.integers(0, 4, (B, M, N)) / 4.0
    elif case == "forbidden":
        s = rng.uniform(0, 1, (B, M, N))
        s[0, :3] = -np.inf
        s[1, :, :4] = -np.inf
        s[2] = -np.inf
    else:  # contested: every row wants column 0 most
        s = rng.uniform(0, 0.1, (B, M, N))
        s[:, :, 0] = 1.0 + rng.uniform(0, 1e-3, (B, M))
    return s.astype(np.float32)


@pytest.mark.parametrize("case,eps,max_iters", [
    ("random", 5e-3, 1000), ("ties", 5e-3, 1000), ("forbidden", 1e-3, 1000),
    ("contested", 1e-3, 1000), ("contested", 1e-4, 7), ("ties", 5e-3, 3)])
def test_auction_equals_jax(case, eps, max_iters):
    rng = np.random.default_rng(len(case) + max_iters)
    s = _scores(case, rng)
    want = jgt.auction_assignment(jnp.asarray(s), min_score=0.2, eps=eps, max_iters=max_iters)
    got = gt_lines.auction_assignment(torch.from_numpy(s), min_score=0.2, eps=eps,
                                      max_iters=max_iters)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] >= 0).any()
    if max_iters < 10:  # the cap stopped a loop that had not converged
        *counted, n = gt_lines.auction_with_count(torch.from_numpy(s), min_score=0.2, eps=eps,
                                                  max_iters=max_iters)
        assert n == max_iters
        for g, c in zip(got, counted):
            torch.testing.assert_close(g, c)


def test_auction_iteration_count():
    """The count of iterations with a bidder is the JAX loop's trip count:
    more than one block of host checks here, fewer than the cap."""
    s = _scores("contested", np.random.default_rng(0))
    n = gt_lines.auction_with_count(torch.from_numpy(s), min_score=0.0, eps=1e-4)[2]
    assert gt_lines.CHECK_EVERY < n < 1000
    full = gt_lines.auction_assignment(torch.from_numpy(s), min_score=0.0, eps=1e-4)
    capped = gt_lines.auction_assignment(torch.from_numpy(s), min_score=0.0, eps=1e-4,
                                         max_iters=n)
    for a, b in zip(full, capped):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("case", ["random", "ties", "forbidden"])
def test_greedy_equals_jax(case):
    s = _scores(case, np.random.default_rng(5))
    want = jgt.greedy_assignment(jnp.asarray(s), min_score=0.3)
    got = gt_lines.greedy_assignment(torch.from_numpy(s), min_score=0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _line_pair(seed, B=2, L=24, shape=(96, 128)):
    """Segments in view 0, their images under a homography with noise
    (shuffled, some replaced by random segments, some out of view) in
    view 1; masks with padded lines."""
    rng = np.random.default_rng(seed)
    h, w = shape
    H = np.tile(np.eye(3), (B, 1, 1))
    H[:, :2, :2] += rng.normal(scale=0.05, size=(B, 2, 2))
    H[:, :2, 2] = rng.normal(scale=6, size=(B, 2))
    H[:, 2, :2] = rng.normal(scale=2e-4, size=(B, 2))
    l0 = rng.uniform([0, 0], [w, h], (B, L, 2, 2))
    pts = np.concatenate([l0.reshape(B, -1, 2), np.ones((B, 2 * L, 1))], -1)
    warped = np.einsum("bij,bnj->bni", H, pts)
    l1 = (warped[..., :2] / warped[..., 2:]).reshape(B, L, 2, 2)
    l1 = l1 + rng.normal(scale=0.8, size=l1.shape)
    l1 = l1[:, rng.permutation(L)]
    l1[:, :5] = rng.uniform([0, 0], [w, h], (B, 5, 2, 2))
    l1[:, 5:7] += 300.0  # out of the image
    m0, m1 = np.ones((B, L), bool), np.ones((B, L), bool)
    m0[0, -3:] = False
    m1[1, -4:] = False
    return (l0.astype(np.float32), l1.astype(np.float32), m0, m1, H.astype(np.float32))


@pytest.mark.parametrize("seed,n_samples,th", [(0, 50, 5.0), (1, 20, 3.0), (2, 50, 2.0)])
def test_homography_line_gt_equals_jax(seed, n_samples, th):
    l0, l1, m0, m1, H = _line_pair(seed)
    kw = {"n_samples": n_samples, "perp_dist_th": th}
    want = jgt.gt_line_matches_from_homography(*(jnp.asarray(a) for a in (l0, l1, m0, m1)),
                                               (96, 128), (96, 128), jnp.asarray(H), **kw)
    got = gt_lines.gt_line_matches_from_homography(*(torch.from_numpy(a) for a in (l0, l1, m0, m1)),
                                                   (96, 128), (96, 128), torch.from_numpy(H), **kw)
    for k in ("matches0", "matches1", "assignment"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    m = got["matches0"].numpy()
    assert (m >= 0).sum() >= 10 and (m == -1).sum() >= 3 and (m == -2).sum() == 3


def test_homography_matcher_with_lines_equals_jax():
    l0, l1, m0, m1, H = _line_pair(3)
    B = l0.shape[0]
    rng = np.random.default_rng(3)
    kp0 = rng.uniform(0, 96, (B, 20, 2)).astype(np.float32)
    kp1 = rng.uniform(0, 96, (B, 20, 2)).astype(np.float32)
    img = np.zeros((B, 96, 128, 1), np.float32)
    data = {"keypoints0": kp0, "keypoints1": kp1, "H_0to1": H, "lines0": l0, "lines1": l1,
            "line_mask0": m0, "line_mask1": m1, "view0": {"image": img}, "view1": {"image": img}}
    conf = {"use_lines": True, "n_line_sampled_pts": 30}
    to_j = lambda d: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v)  # noqa: E731
                      for k, v in d.items()}
    to_t = lambda d: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                      for k, v in d.items()}
    want = JaxHM.from_conf(conf).apply({}, to_j(data))
    got = get_model("homography_matcher").from_conf(conf, device="cpu")(to_t(data))
    assert set(got) == set(want) and "gt_line_assignment" in got
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
