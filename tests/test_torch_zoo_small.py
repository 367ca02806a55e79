"""The port's small zoo modules against the JAX package's on the same
seeded inputs: `grid_extractor` (RoMa's sparse-mode keypoints), `mixed`
(a detector and a descriptor model combined) and `lightglue_pretrained`
(LightGlue configured by feature type).

Weights come from the JAX package's `init` through `from_jax_params`.
Tolerances: the grid exact; the mixed extractor's descriptors 2e-5
(SuperPoint's float32 convs summed in another order, as in
`test_torch_superpoint.py`); LightGlue's log assignment 1e-4 and scores
1e-5, as in `test_torch_lightglue.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.matchers.lightglue_pretrained import FEATURE_CONFS

SP = {"name": "superpoint", "channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
      "max_num_keypoints": 48, "detection_threshold": 0.0, "dense_outputs": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this file's tests: the suite runs in several
    worker processes at once, where each process's default of one thread
    a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,hw", [(14, (75, 101)), (8, (64, 96))])
def test_grid_extractor(cell, hw):
    image = np.random.default_rng(0).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = jax_get_model("grid_extractor").from_conf({"cell_size": cell}).apply({}, {"image": jnp.asarray(image)})
    out = get_model("grid_extractor").from_conf({"cell_size": cell}, device="cpu")({"image": torch.from_numpy(image)})
    assert out["keypoints"].shape == (2, (hw[0] // cell) * (hw[1] // cell), 2)
    for k in ("keypoints", "keypoint_scores", "keypoint_mask"):
        assert out[k].dtype == {"keypoint_mask": torch.bool}.get(k, torch.float32)
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("interpolate", ["dense_descriptors", None])
def test_mixed_extractor(interpolate):
    """The grid's keypoints with SuperPoint's descriptors: sampled from its
    dense map at the grid's keypoints, or SuperPoint's own."""
    conf = {"detector": {"name": "grid_extractor", "cell_size": 8}, "descriptor": SP,
            "interpolate_descriptors_from": interpolate}
    image = np.random.default_rng(1).uniform(0, 1, (2, 64, 96, 1)).astype(np.float32)
    model_j = jax_get_model("mixed").from_conf(conf)
    data_j = {"image": jnp.asarray(image)}
    variables = jax.jit(model_j.init)({"params": jax.random.key(0)}, data_j)
    ref = jax.jit(model_j.apply)(variables, data_j)
    port = get_model("mixed").from_conf(conf, device="cpu").eval()
    sd = from_jax_params(variables["params"]["descriptor_model"], "superpoint")
    port.load_state_dict({f"descriptor_model.{k}": v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = port({"image": torch.from_numpy(image)})
    grid = get_model("grid_extractor").from_conf({"cell_size": 8}, device="cpu")(
        {"image": torch.from_numpy(image)})["keypoints"]
    assert torch.equal(out["keypoints"], grid)
    np.testing.assert_array_equal(out["keypoints"].numpy(), np.asarray(ref["keypoints"]))
    assert out["descriptors"].shape == ref["descriptors"].shape
    np.testing.assert_allclose(out["descriptors"].numpy(), np.asarray(ref["descriptors"]), atol=2e-5)
    assert sorted(out) == sorted(ref)


@pytest.mark.parametrize("features", list(FEATURE_CONFS))
def test_lightglue_pretrained_conf(features):
    for conf in ({"features": features}, {"features": features, "n_layers": 3, "input_dim": 64}):
        want = jax_get_model("lightglue_pretrained").resolve_conf(conf).to_dict()
        got = get_model("lightglue_pretrained").resolve_conf(conf).to_dict()
        assert got == want
        assert got["add_scale_ori"] == (features == "sift") and got["depth_confidence"] == 0.95


def _lg_inputs(rng, D, scale_ori: bool, M=36, N=30):
    k0 = rng.uniform(0, 128, (1, M, 2))
    d0 = rng.normal(size=(1, M, D))
    perm = rng.permutation(M)[:N]
    data = {"keypoints0": k0, "keypoints1": k0[:, perm] + rng.normal(scale=0.5, size=(1, N, 2)),
            "descriptors0": d0, "descriptors1": d0[:, perm] + rng.normal(scale=0.1, size=(1, N, D)),
            "keypoint_mask0": np.ones((1, M), bool), "keypoint_mask1": np.ones((1, N), bool),
            "image_size0": np.array([[128.0, 96.0]]), "image_size1": np.array([[128.0, 96.0]])}
    if scale_ori:
        for i, n in ((0, M), (1, N)):
            data[f"scales{i}"] = rng.uniform(1, 8, (1, n))
            data[f"oris{i}"] = rng.uniform(-np.pi, np.pi, (1, n))
    return {k: v.astype(np.float32) if v.dtype != bool else v for k, v in data.items()}


@pytest.mark.parametrize("features", ["superpoint", "sift"])
def test_lightglue_pretrained_matches_jax_and_lightglue(features):
    """Dense (no pruning) against the JAX package's `lightglue_pretrained`;
    then, at the defaults' adaptive depth and width, equal to the port's
    `lightglue` built from the same resolved conf and weights."""
    conf = {"features": features, "n_layers": 2, "depth_confidence": -1, "width_confidence": -1,
            "filter_threshold": 0.01}
    D = FEATURE_CONFS[features]["input_dim"]
    data = _lg_inputs(np.random.default_rng(2), D, features == "sift")
    model_j = jax_get_model("lightglue_pretrained").from_conf({**conf, "checkpointed": False})
    dj = {k: jnp.asarray(v) for k, v in data.items()}
    params = jax.jit(model_j.init, static_argnames="method")({"params": jax.random.key(0)}, dj,
                                                             method="initialize")["params"]
    ref = jax.jit(model_j.apply)({"params": params}, dj)
    sd = from_jax_params(params, "lightglue", 4)
    port = get_model("lightglue_pretrained").from_conf(conf, device="cpu").eval()
    port.load_state_dict(sd, strict=True)
    dt = {k: torch.from_numpy(v) for k, v in data.items()}
    with torch.no_grad():
        out = port(dt)
    np.testing.assert_allclose(out["log_assignment"].numpy(), np.asarray(ref["log_assignment"]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(out["matches0"].numpy(), np.asarray(ref["matches0"]))
    np.testing.assert_allclose(out["matching_scores0"].numpy(), np.asarray(ref["matching_scores0"]), atol=1e-5)
    assert (out["matches0"] >= 0).sum() >= 5

    pre = get_model("lightglue_pretrained").from_conf({"features": features, "n_layers": 2},
                                                      device="cpu").eval()
    plain = get_model("lightglue").from_conf(
        {k: v for k, v in pre.conf.to_dict().items() if k not in ("features", "name")}, device="cpu").eval()
    pre.load_state_dict(sd)
    plain.load_state_dict(sd)
    with torch.no_grad():
        a, b = pre(dt), plain(dt)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
