"""The port's nearest-neighbour matcher against the JAX package's on the
same seeded descriptors: `find_nn` and `mutual_check`, the forward under
the ratio and distance tests, the mutual check and padded keypoints
(matches exact, scores and the log assignment within 1e-6), the N-pair
loss and its gradient against `jax.grad`, `superpoint+NN` through the
pipeline, and the matcher's registry name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.ops import assignment as jax_assignment
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops import assignment

TOL = 1e-6
CASES = {
    "plain": {},
    "no_mutual": {"mutual_check": False},
    "ratio": {"ratio_thresh": 0.95},
    "distance": {"distance_thresh": 0.9},
    "ratio_distance_no_mutual": {"ratio_thresh": 0.97, "distance_thresh": 1.0,
                                 "mutual_check": False},
}


def _descriptors(rng, B=2, M=50, N=43, D=32, masks=True):
    """Unit descriptors; view 1 holds a jittered copy of part of view 0, so
    that the tests pass and fail on both sides of their thresholds."""
    d0 = rng.normal(size=(B, M, D))
    d1 = rng.normal(size=(B, N, D))
    perm = rng.permutation(M)[:N // 2]
    d1[:, :N // 2] = d0[:, perm] + rng.normal(scale=0.3, size=(B, N // 2, D))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    data = {"descriptors0": d0.astype(np.float32), "descriptors1": d1.astype(np.float32)}
    if masks:
        m0, m1 = rng.uniform(size=(B, M)) > 0.2, rng.uniform(size=(B, N)) > 0.2
        m0[1] = False  # one item with no keypoint in view 0
        data.update(keypoint_mask0=m0, keypoint_mask1=m1)
    return data


def _run_jax(conf, data, params=None):
    model = jax_get_model("nearest_neighbor_matcher").from_conf(conf)
    dj = {k: jnp.asarray(v) for k, v in data.items()}
    variables = params if params is not None else model.init(jax.random.key(0), dj)
    return model, variables, jax.tree.map(np.asarray, model.apply(variables, dj))


def _run_port(conf, data):
    model = get_model("nearest_neighbor_matcher").from_conf(conf, device="cpu")
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in data.items()})
    return model, out


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("ratio_th,distance_th", [(None, None), (0.95, None), (None, 0.9), (0.97, 1.0)])
def test_find_nn_and_mutual_check_match_jax(ratio_th, distance_th, masks):
    data = _descriptors(np.random.default_rng(1), masks=masks)
    sim = np.einsum("bnd,bmd->bnm", data["descriptors0"], data["descriptors1"])
    m0 = data.get("keypoint_mask0")
    m1 = data.get("keypoint_mask1")
    jm = lambda m: None if m is None else jnp.asarray(m)  # noqa: E731
    tm = lambda m: None if m is None else torch.from_numpy(m)  # noqa: E731
    want_m, want_s = jax_assignment.find_nn(jnp.asarray(sim), ratio_th, distance_th, jm(m0), jm(m1))
    got_m, got_s = assignment.find_nn(torch.from_numpy(sim), ratio_th, distance_th, tm(m0), tm(m1))
    assert got_m.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=TOL, rtol=0)
    want_1, _ = jax_assignment.find_nn(jnp.asarray(sim).swapaxes(1, 2), ratio_th, distance_th)
    got_1, _ = assignment.find_nn(torch.from_numpy(sim).transpose(1, 2), ratio_th, distance_th)
    mutual = assignment.mutual_check(got_m, got_1)
    np.testing.assert_array_equal(mutual.numpy(), np.asarray(jax_assignment.mutual_check(want_m, want_1)))
    assert (mutual >= 0).sum() > 0 and (mutual == -1).sum() > 0


def test_find_nn_breaks_ties_by_the_lower_index():
    """Equal similarities (a row of padding at -1e9, duplicated columns):
    the first and second neighbours in index order, as `lax.top_k`."""
    sim = np.array([[[0.5, 0.9, 0.9, 0.1], [-1e9, -1e9, -1e9, -1e9], [0.2, 0.2, 0.3, 0.3]]],
                   np.float32)
    want, _ = jax_assignment.find_nn(jnp.asarray(sim), 1.0)
    got, _ = assignment.find_nn(torch.from_numpy(sim), 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(assignment._top2(torch.from_numpy(sim))[1].numpy(),
                                  np.asarray(jax.lax.top_k(jnp.asarray(sim), 2)[1]))


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, masks):
    conf = CASES[case]
    data = _descriptors(np.random.default_rng(2), masks=masks)
    _, _, want = _run_jax(conf, data)
    _, got = _run_port(conf, data)
    assert set(got) == set(want)
    for k in ("matches0", "matches1"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("matching_scores0", "matching_scores1", "log_assignment", "similarity"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=TOL, rtol=TOL, err_msg=k)
    assert got["log_assignment"].shape[1:] == (51, 44)
    assert (got["matches0"] >= 0).sum() >= 5
    if masks:
        for i in "01":
            assert (got[f"matches{i}"][~torch.from_numpy(data[f"keypoint_mask{i}"])] == -1).all()


def _gt(rng, B, M, N):
    gt = np.zeros((B, M, N), bool)
    for b in range(B):
        rows = rng.choice(M, 12, replace=False)
        cols = rng.choice(N, 12, replace=False)
        gt[b, rows, cols] = True
    m0 = np.where(gt.any(2), gt.argmax(2), -1).astype(np.int32)
    m1 = np.where(gt.any(1), gt.argmax(1), -1).astype(np.int32)
    return {"gt_assignment": gt, "gt_matches0": m0, "gt_matches1": m1}


@pytest.mark.parametrize("train", [True, False])
def test_n_pair_loss_and_gradient_match_jax(train):
    rng = np.random.default_rng(3)
    data = _descriptors(rng, masks=False)
    data.update(_gt(rng, 2, 50, 43))
    conf = {"loss": "N_pair"}
    jm, variables, _ = _run_jax(conf, data)
    variables = {"params": {"temperature": jnp.asarray(1.7, jnp.float32)}}
    dj = {k: jnp.asarray(v) for k, v in data.items()}

    def jax_loss(params, d0, d1):
        d = {**dj, "descriptors0": d0, "descriptors1": d1}
        pred = jm.apply({"params": params}, d)
        losses, metrics = jm.apply({"params": params}, pred, d, train=train, method="loss")
        return losses["total"].mean(), (losses, metrics)

    (_, (want, want_metrics)), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], dj["descriptors0"], dj["descriptors1"])

    model = get_model("nearest_neighbor_matcher").from_conf(conf, device="cpu")
    model.load_state_dict({"temperature": torch.tensor(1.7)})
    dt = {k: torch.from_numpy(v) for k, v in data.items()}
    dt["descriptors0"].requires_grad_(True)
    dt["descriptors1"].requires_grad_(True)
    _, losses, metrics = model.forward_with_loss(dt, train=train)
    losses["total"].mean().backward()
    assert set(losses) == set(want) and set(metrics) == set(want_metrics)
    assert (metrics == {}) == train
    for k, v in want.items():
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(v), rtol=1e-5, err_msg=k)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(model.temperature.grad), float(grads[0]["temperature"]), rtol=1e-5)
    for i in (0, 1):
        g, w = dt[f"descriptors{i}"].grad.numpy(), np.asarray(grads[i + 1])
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0)


def test_without_loss_there_is_no_parameter_and_no_loss():
    model = get_model("nearest_neighbor_matcher").from_conf({}, device="cpu")
    assert list(model.parameters()) == []
    with pytest.raises(NotImplementedError):
        model.loss({}, {})


def test_superpoint_nn_config_through_the_pipeline():
    """`superpoint+NN` resolves by name and its pipeline runs the matcher
    on SuperPoint's outputs (small images, random weights); the matches
    equal a recomputation from the pipeline's own descriptors."""
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.eval.io import parse_config_path

    conf = from_yaml(str(parse_config_path("superpoint+NN")))
    assert conf.model.matcher.name == "nearest_neighbor_matcher"
    mconf = {k: v for k, v in conf.model.to_dict().items() if k != "name"}
    mconf["extractor"]["max_num_keypoints"] = 64
    torch.manual_seed(0)
    model = get_model("two_view_pipeline").from_conf(mconf, device="cpu").eval()
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(size=(1, 96, 128, 1)).astype(np.float32))
    view = {"image": img, "image_size": torch.tensor([[128.0, 96.0]])}
    with torch.no_grad():
        pred = model({"view0": view, "view1": {**view, "image": img.flip(2)}})
        again = model.matcher({k: v for k, v in pred.items() if k.startswith(("descriptors", "keypoint_mask"))})
    for k in ("matches0", "matches1"):
        torch.testing.assert_close(pred[k], again[k])
    assert pred["descriptors0"].shape == (1, 64, 256)
