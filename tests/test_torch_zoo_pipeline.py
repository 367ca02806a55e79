"""The learned-extractor zoo in the port's pipeline: scaled-down
`aliked+lightglue-official` / `disk+lightglue-official` pipelines against
the JAX package's on the same seeded images and the same weights (random,
`zoo_params.random_variables`, carried across by `from_jax_params`), and
`from_jax_params` telling each extractor of a pipeline apart (the eleven
configs by name: `test_torch_zoo_configs.py`).

Tolerances: 1e-4 absolute on keypoints (ALIKED's are refined, so float),
descriptors and matching scores, 2e-4 on the log assignment (f32 convs
and matmuls summed in another order); masks and matches equal. View 1 is
view 0 plus faint noise, so that random weights still match; every
keypoint slot is a detection (threshold 0, few keypoints).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from zoo_params import random_variables

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import _extractor_name, from_jax_params
from gluefactory_tpu_torch.core.config import from_yaml, merge
from gluefactory_tpu_torch.eval.io import parse_config_path
from gluefactory_tpu_torch.models import get_model

H, W, K = 64, 96, 32
PIPES = {
    "aliked+lightglue-official": {"extractor": {"model_name": "aliked-t16", "max_num_keypoints": K},
                                  "matcher": {"input_dim": 64}},
    "disk+lightglue-official": {"extractor": {"desc_dim": 32, "max_num_keypoints": K},
                                "matcher": {"input_dim": 32}},
}
MATCHER = {"n_layers": 2, "descriptor_dim": 64, "num_heads": 2, "checkpointed": False, "filter_threshold": 0.0}


def _data(seed=0, B=2):
    rng = np.random.default_rng(seed)
    img0 = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(scale=1e-3, size=img0.shape), 0, 1).astype(np.float32)
    size = np.asarray([[W, H], [W - 6, H - 4]], np.float32)
    return {"view0": {"image": img0, "image_size": size}, "view1": {"image": img1, "image_size": size}}


def _to(data, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


def _pipeline_conf(name):
    conf = from_yaml(str(parse_config_path(name))).model.to_dict()
    conf = merge(conf, PIPES[name], {"matcher": MATCHER}).to_dict()
    return {k: v for k, v in conf.items() if k != "name"}


@pytest.fixture(scope="module", params=sorted(PIPES))
def pipe_run(request):
    conf = _pipeline_conf(request.param)
    data = _data()
    pipe_j = jax_get_model("two_view_pipeline").from_conf(conf)
    dj = _to(data, jnp.asarray)
    variables = random_variables(pipe_j, dj, method="initialize")
    ref = jax.jit(pipe_j.apply)(variables, dj)
    pipe_t = get_model("two_view_pipeline").from_conf(conf, device="cpu").eval()
    pipe_t.load_state_dict(from_jax_params(variables["params"], "two_view_pipeline", num_heads=2,
                                           batch_stats=variables.get("batch_stats")))
    with torch.no_grad():
        out = pipe_t(_to(data, torch.from_numpy))
    return request.param, {k: np.asarray(v) for k, v in ref.items()}, out, variables


def test_pipeline_matches_jax(pipe_run):
    name, ref, out, _ = pipe_run
    assert set(out) == set(ref)
    for i in "01":
        assert out[f"keypoint_mask{i}"].all()
        np.testing.assert_array_equal(out[f"keypoint_mask{i}"].numpy(), ref[f"keypoint_mask{i}"])
        for k in ("keypoints", "descriptors", "keypoint_scores"):
            np.testing.assert_allclose(out[f"{k}{i}"].numpy(), ref[f"{k}{i}"], atol=1e-4, rtol=1e-4,
                                       err_msg=f"{name} {k}{i}")
    np.testing.assert_allclose(out["log_assignment"].numpy(), ref["log_assignment"], atol=2e-4, rtol=1e-5)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k])
    assert (out["matches0"] >= 0).sum() > 0
    np.testing.assert_allclose(out["matching_scores0"].numpy(), ref["matching_scores0"], atol=1e-4)


def test_from_jax_params_tells_the_extractor_apart(pipe_run):
    name, _, _, variables = pipe_run
    assert _extractor_name(variables["params"]["extractor_model"]) == name.split("+")[0]


def test_from_jax_params_superpoint_open_pipeline():
    """A pipeline of the open SuperPoint and LightGlue: its `conv1a` holds a
    `BatchNorm_0`, so the extractor converts as `superpoint_open`, with
    its statistics, and the state dict loads strictly."""
    conf = {"extractor": {"name": "superpoint_open", "channels": [8, 8, 16, 16], "head_channels": 32,
                          "descriptor_dim": 32, "max_num_keypoints": K},
            "matcher": {"name": "lightglue", "input_dim": 32, **MATCHER}}
    pipe_j = jax_get_model("two_view_pipeline").from_conf(conf)
    data = _to(_data(), jnp.asarray)
    for v in data.values():
        v["image"] = v["image"][..., :1]
    variables = random_variables(pipe_j, data, method="initialize")
    assert _extractor_name(variables["params"]["extractor_model"]) == "superpoint_open"
    sd = from_jax_params(variables["params"], "two_view_pipeline", num_heads=2,
                         batch_stats=variables["batch_stats"])
    pipe_t = get_model("two_view_pipeline").from_conf(conf, device="cpu")
    pipe_t.load_state_dict(sd, strict=True)
    stats = variables["batch_stats"]["extractor_model"]["convPa"]["BatchNorm_0"]["var"]
    np.testing.assert_array_equal(pipe_t.extractor.detector[0].bn.running_var.numpy(), stats)
