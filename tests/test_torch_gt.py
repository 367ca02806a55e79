"""The port's ground truth, losses, metrics and LightGlue loss against the
JAX package's on the same seeded inputs.

- `gt_matches_from_homography`: with padding masks, exact ties (duplicated
  keypoints) and rows whose distances are all inf (a view with every slot
  masked): matches and assignment equal;
- `_assignment_from_dists` on a crafted matrix with ties and inf rows;
- `nll_components` with both clamp conventions, `masked_row_norm`:
  within 1e-6 relative;
- `matcher_metrics` with tied matching scores: within 1e-6;
- LightGlue's `loss` (3 layers, d = 64) at train (deep supervision and the
  token-confidence BCE) and at eval (final NLL and metrics): within 1e-5
  relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import gt_generation as jgt
from gluefactory_tpu.models import losses as jlosses
from gluefactory_tpu.models import metrics as jmetrics
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.geometry import gt_generation as tgt
from gluefactory_tpu_torch.geometry.homography import (homography_corner_error,
                                                       sym_homography_error,
                                                       sym_homography_error_all, warp_points)
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models import losses as tlosses
from gluefactory_tpu_torch.models import metrics as tmetrics
from gluefactory_tpu.geometry import homography as jhom

LG = {"n_layers": 3, "input_dim": 64, "descriptor_dim": 64, "num_heads": 2,
      "filter_threshold": 0.01, "checkpointed": False, "flash": False}


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def homography_case(seed=0, B=3, M=40, N=36):
    """Keypoints of view 1 are view 0's warped by H (jittered), some exact
    duplicates in both views (ties), padding masks, and the last item with
    every view-1 slot masked (all-inf rows)."""
    rng = np.random.default_rng(seed)
    H = np.stack([np.eye(3) + rng.normal(scale=[[0.05, 0.05, 3], [0.05, 0.05, 3], [1e-4, 1e-4, 0]])
                  for _ in range(B)]).astype(np.float32)
    k0 = rng.uniform(0, 100, (B, M, 2)).astype(np.float32)
    k0[:, 5] = k0[:, 4]  # a tie in view 0
    w = np.einsum("bij,bnj->bni", H, np.concatenate([k0, np.ones((B, M, 1), np.float32)], -1))
    k01 = w[..., :2] / w[..., 2:]
    k1 = k01[:, rng.permutation(M)[:N]] + rng.normal(scale=1.5, size=(B, N, 2))
    k1[:, 1] = k1[:, 0]  # a tie in view 1
    k1 = k1.astype(np.float32)
    m0 = rng.uniform(size=(B, M)) > 0.15
    m1 = rng.uniform(size=(B, N)) > 0.15
    m1[B - 1] = False
    return k0, k1, H, m0, m1


@pytest.fixture(scope="module")
def jax_lightglue():
    """The JAX LightGlue's params, a batch with GT, and its losses and
    metrics at train and eval."""
    k0, k1, H, m0, m1 = homography_case(1, B=2, M=32, N=32)
    m1[:] = True  # item-level all-masked views are covered by the GT tests
    rng = np.random.default_rng(2)
    data = {"keypoints0": k0, "keypoints1": k1, "keypoint_mask0": m0, "keypoint_mask1": m1,
            "descriptors0": rng.normal(size=(2, 32, 64)).astype(np.float32),
            "descriptors1": rng.normal(size=(2, 32, 64)).astype(np.float32),
            "image_size0": np.full((2, 2), 100.0, np.float32),
            "image_size1": np.full((2, 2), 100.0, np.float32)}
    gt = jgt.gt_matches_from_homography(J(k0), J(k1), J(H), 3.0, 3.0, J(m0), J(m1))
    data.update(gt_matches0=np.asarray(gt["matches0"]), gt_matches1=np.asarray(gt["matches1"]),
                gt_assignment=np.asarray(gt["assignment"]))
    model = jax_get_model("lightglue").from_conf(LG)
    dj = {k: J(v) for k, v in data.items()}
    params = jax.jit(model.init, static_argnames="method")(
        {"params": jax.random.key(0)}, dj, method="initialize")["params"]
    out = {}
    for train in (True, False):
        _, losses, metrics = jax.jit(model.apply, static_argnames=("method", "train"))(
            {"params": params}, dj, train=train, method="forward_with_loss")
        out[train] = ({k: np.asarray(v) for k, v in losses.items()},
                      {k: np.asarray(v) for k, v in metrics.items()})
    return {"params": params, "data": data, "ref": out}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("masks", [True, False])
def test_gt_matches_from_homography(seed, masks):
    k0, k1, H, m0, m1 = homography_case(seed)
    mj = (J(m0), J(m1)) if masks else (None, None)
    mt = (T(m0), T(m1)) if masks else (None, None)
    want = jgt.gt_matches_from_homography(J(k0), J(k1), J(H), 3.0, 6.0, *mj)
    got = tgt.gt_matches_from_homography(T(k0), T(k1), T(H), 3.0, 6.0, *mt)
    for key in ("matches0", "matches1", "assignment"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert (got["matches0"] >= 0).sum() > 10  # the case has positives
    if masks:
        assert (got["matches0"][~T(m0)] == tgt.IGNORE).all()
        assert (got["matches1"][2] == tgt.IGNORE).all()


def test_assignment_ties_and_inf_rows():
    inf = np.inf
    dist = np.array([[[1.0, 1.0, 9.0, 50.0],  # tie in row 0 and column 0
                      [1.0, 4.0, 4.0, 50.0],
                      [inf, inf, inf, inf],  # all-inf row
                      [50.0, 2.0, 2.0, 0.5]]], np.float32)
    neg0 = np.array([[False, False, True, False]])
    neg1 = np.array([[False, False, False, True]])
    ign0 = np.array([[False, False, True, False]])
    for ignore in (False, True):
        args = (9.0,)
        want = jgt._assignment_from_dists(J(dist), *args, J(neg0), J(neg1),
                                          J(ign0) if ignore else None)
        got = tgt._assignment_from_dists(T(dist), *args, T(neg0), T(neg1),
                                         T(ign0) if ignore else None)
        for key in ("matches0", "matches1", "assignment"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert int(got["matches0"][0, 0]) == 0  # the first of two equal minima


def test_gt_from_matches0():
    m0 = np.array([[2, -1, 0, -2, 1]], np.int32)
    np.testing.assert_array_equal(tgt.gt_from_matches0(T(m0), 3).numpy(),
                                  np.asarray(jgt.gt_from_matches0(J(m0), 3)))


def test_homography_warps_and_errors():
    k0, k1, H, _, _ = homography_case(3)
    for inverse in (False, True):
        np.testing.assert_allclose(warp_points(T(k0), T(H), inverse).numpy(),
                                   np.asarray(jhom.warp_points(J(k0), J(H), inverse)),
                                   rtol=1e-5, atol=1e-4)
    k1 = k1[:, :40] if k1.shape[1] >= 40 else np.concatenate([k1, k1[:, :4]], 1)
    np.testing.assert_allclose(sym_homography_error(T(k0), T(k1), T(H)).numpy(),
                               np.asarray(jhom.sym_homography_error(J(k0), J(k1), J(H))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sym_homography_error_all(T(k0), T(k1), T(H)).numpy(),
                               np.asarray(jhom.sym_homography_error_all(J(k0), J(k1), J(H))),
                               rtol=1e-5, atol=1e-4)
    size = np.array([[100.0, 80.0]] * 3, np.float32)
    H2 = H @ np.diag([1.01, 0.99, 1.0]).astype(np.float32)
    np.testing.assert_allclose(homography_corner_error(T(H), T(H2), T(size)).numpy(),
                               np.asarray(jhom.homography_corner_error(J(H), J(H2), J(size))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("per_side_clamp", [True, False])
def test_nll_components(per_side_clamp):
    k0, k1, H, m0, m1 = homography_case(4)
    gt = jgt.gt_matches_from_homography(J(k0), J(k1), J(H), 3.0, 3.0, J(m0), J(m1))
    rng = np.random.default_rng(5)
    la = np.log(rng.dirichlet(np.ones(37), size=(3, 41))).astype(np.float32)
    want = jlosses.nll_components(J(la), gt["assignment"], gt["matches0"], gt["matches1"],
                                  per_side_clamp)
    got = tlosses.nll_components(T(la), T(gt["assignment"]), T(gt["matches0"]),
                                 T(gt["matches1"]), per_side_clamp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert float(got[3][2]) >= 1.0  # item 2: no negative in view 1, clamped
    for mask in (None, m0):
        np.testing.assert_allclose(
            tlosses.masked_row_norm(T(la), None if mask is None else T(mask)).numpy(),
            np.asarray(jlosses.masked_row_norm(J(la), None if mask is None else J(mask))),
            rtol=1e-6)


def test_matcher_metrics_with_tied_scores():
    rng = np.random.default_rng(6)
    gt = rng.integers(-2, 20, (3, 30)).astype(np.int32)
    m = np.where(rng.uniform(size=(3, 30)) < 0.6, gt, rng.integers(-1, 20, (3, 30))).astype(np.int32)
    scores = np.round(rng.uniform(size=(3, 30)), 1).astype(np.float32)  # many ties
    pred = {"matches0": m, "matching_scores0": scores}
    want = jmetrics.matcher_metrics({k: J(v) for k, v in pred.items()}, {"gt_matches0": J(gt)})
    got = tmetrics.matcher_metrics({k: T(v) for k, v in pred.items()}, {"gt_matches0": T(gt)})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_lightglue_loss(jax_lightglue, train):
    model = get_model("lightglue").from_conf(LG, device="cpu")
    model.load_state_dict(from_jax_params(jax_lightglue["params"], "lightglue", LG["num_heads"]))
    data = {k: T(v) for k, v in jax_lightglue["data"].items()}
    with torch.no_grad():
        _, losses, metrics = model.forward_with_loss(data, train=train)
    want_losses, want_metrics = jax_lightglue["ref"][train]
    assert set(losses) == set(want_losses) and set(metrics) == set(want_metrics)
    assert ("confidence" in losses) == train and bool(metrics) == (not train)
    for k, w in {**want_losses, **want_metrics}.items():
        g = {**losses, **metrics}[k].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)
