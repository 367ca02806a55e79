"""`from_jax_params`: JAX parameters -> state dicts that the port's models
load strictly, and the inverse of the JAX package's converter from the
official torch layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import (
    _head_permutation,
    _qkv_permutation,
    convert_lightglue,
    convert_superglue,
    convert_superpoint,
)
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import (
    from_jax_params,
    head_fastest_permutation,
    qkv_permutation,
)
from gluefactory_tpu_torch.models import get_model

SP_CONF = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
           "max_num_keypoints": 16}
LG_CONF = {"n_layers": 2, "descriptor_dim": 64, "input_dim": 32, "num_heads": 2}
SG_CONF = {"n_layers": 2, "descriptor_dim": 32, "keypoint_encoder": [8, 16], "num_heads": 2,
           "checkpointed": False}


def _matcher_data(rng, B=1, M=16, N=16, D=32):
    return {
        "keypoints0": jnp.asarray(rng.uniform(0, 64, (B, M, 2)), jnp.float32),
        "keypoints1": jnp.asarray(rng.uniform(0, 64, (B, N, 2)), jnp.float32),
        "descriptors0": jnp.asarray(rng.normal(size=(B, M, D)), jnp.float32),
        "descriptors1": jnp.asarray(rng.normal(size=(B, N, D)), jnp.float32),
        "keypoint_scores0": jnp.asarray(rng.uniform(0, 1, (B, M)), jnp.float32),
        "keypoint_scores1": jnp.asarray(rng.uniform(0, 1, (B, N)), jnp.float32),
        "image_size0": jnp.asarray([[64.0, 64.0]] * B),
        "image_size1": jnp.asarray([[64.0, 64.0]] * B),
    }


def _image_data(rng, B=1, H=32, W=32):
    view = lambda: {"image": jnp.asarray(rng.uniform(0, 1, (B, H, W, 1)), jnp.float32),
                    "image_size": jnp.asarray([[W, H]] * B, jnp.float32)}
    return {"view0": view(), "view1": view()}


def _load_strict(name, conf, sd):
    model = get_model(name).from_conf(conf, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def test_superpoint_params_load_strict():
    rng = np.random.default_rng(0)
    sp = jax_get_model("superpoint").from_conf(SP_CONF)
    params = jax.jit(sp.init)({"params": jax.random.key(0)}, _image_data(rng)["view0"])["params"]
    model = _load_strict("superpoint", SP_CONF, from_jax_params(params, "superpoint"))
    kernel = np.asarray(params["conv2a"]["Conv_0"]["kernel"])  # HWIO
    np.testing.assert_array_equal(model.conv2a.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))


def test_lightglue_params_load_strict():
    rng = np.random.default_rng(1)
    lg = jax_get_model("lightglue").from_conf({**LG_CONF, "checkpointed": False})
    params = lg.init({"params": jax.random.key(1)}, _matcher_data(rng), method="initialize")
    sd = from_jax_params(params["params"], "lightglue", num_heads=2)
    model = _load_strict("lightglue", LG_CONF, sd)
    fc1 = np.asarray(params["params"]["transformers_1"]["cross_attn"]["ffn"]["fc1"]["kernel"])
    np.testing.assert_array_equal(model.transformers[1].cross_attn.ffn[0].weight.detach().numpy(), fc1.T)


def test_pipeline_params_load_strict():
    rng = np.random.default_rng(2)
    conf = {"extractor": {"name": "superpoint", **SP_CONF},
            "matcher": {"name": "lightglue", **LG_CONF, "checkpointed": False}}
    pipe = jax_get_model("two_view_pipeline").from_conf(conf)
    params = pipe.init({"params": jax.random.key(2)}, _image_data(rng), method="initialize")
    sd = from_jax_params(params["params"], "two_view_pipeline", num_heads=2)
    assert any(k.startswith("extractor.") for k in sd) and any(k.startswith("matcher.") for k in sd)
    _load_strict("two_view_pipeline", conf, sd)


def test_superglue_params_load_strict():
    rng = np.random.default_rng(3)
    sg = jax_get_model("superglue").from_conf(SG_CONF)
    variables = sg.init({"params": jax.random.key(3)}, _matcher_data(rng))
    sd = from_jax_params(variables["params"], "superglue", num_heads=2,
                         batch_stats=variables["batch_stats"])
    model = _load_strict("superglue", SG_CONF, sd)
    mlp = variables["params"]["gnn_1"]["mlp"]["dense_1"]["kernel"]
    np.testing.assert_array_equal(model.gnn.layers[1].mlp[3].weight[..., 0].detach().numpy(),
                                  np.asarray(mlp).T)
    with pytest.raises(ValueError, match="batch_stats"):
        from_jax_params(variables["params"], "superglue", num_heads=2)


def test_superglue_pipeline_params_load_strict():
    rng = np.random.default_rng(4)
    conf = {"extractor": {"name": "superpoint", **SP_CONF},
            "matcher": {"name": "superglue", **SG_CONF}}
    pipe = jax_get_model("two_view_pipeline").from_conf(conf)
    variables = pipe.init({"params": jax.random.key(4)}, _image_data(rng), method="initialize")
    sd = from_jax_params(variables["params"], "two_view_pipeline", num_heads=2,
                         batch_stats=variables["batch_stats"])
    assert "matcher.kenc.encoder.1.running_var" in sd
    _load_strict("two_view_pipeline", conf, sd)


@pytest.mark.parametrize("dim,heads", [(64, 2), (256, 4)])
def test_qkv_permutation_matches_jax_converter(dim, heads):
    np.testing.assert_array_equal(qkv_permutation(dim, heads), _qkv_permutation(dim, heads))
    np.testing.assert_array_equal(head_fastest_permutation(dim, heads), _head_permutation(dim, heads))


def test_official_layout_round_trip():
    """A random state dict of the port (the official layout) through the JAX
    package's converter and back comes out unchanged: `from_jax_params`
    inverts `convert_lightglue` / `convert_superpoint`, Wqkv permutation
    included."""
    torch.manual_seed(0)
    lg = get_model("lightglue").from_conf(
        {"n_layers": 2, "descriptor_dim": 64, "input_dim": 64, "num_heads": 4}, device="cpu")
    sd = {k: v.detach().numpy() for k, v in lg.state_dict().items()}
    back = from_jax_params(convert_lightglue(sd, n_layers=2, dim=64, num_heads=4), "lightglue", 4)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)

    sp = get_model("superpoint").from_conf({}, device="cpu")
    sd = {k: v.detach().numpy() for k, v in sp.state_dict().items()}
    back = from_jax_params(convert_superpoint(sd), "superpoint")
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_superglue_official_layout_round_trip():
    """A random official-layout SuperGlue state dict (non-trivial BatchNorm
    statistics) through `convert_superglue` and back comes out unchanged,
    head permutation included, and loads into the port strictly."""
    conf = {"n_layers": 2, "descriptor_dim": 64, "num_heads": 4}  # the official 5-conv encoder
    rng = np.random.default_rng(5)
    sg = get_model("superglue").from_conf(conf, device="cpu")
    sd = {k: (rng.uniform(0.5, 2.0, v.shape) if k.endswith("running_var")
              else rng.normal(size=v.shape)).astype(np.float32) if v.is_floating_point()
          else v.numpy() for k, v in sg.state_dict().items()}
    params, stats = convert_superglue(sd, n_layers=2, dim=64, num_heads=4)
    back = from_jax_params(params, "superglue", num_heads=4, batch_stats=stats)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    sg.load_state_dict(back, strict=True)


@pytest.mark.parametrize("params,model", [
    ({}, "loftr"),  # a matcher with no converter
    ({"matcher_model": {"MLP_0": {}}}, "two_view_pipeline"),  # a matcher with no converter
])
def test_unknown_model_raises(params, model):
    with pytest.raises(ValueError):
        from_jax_params(params, model)
