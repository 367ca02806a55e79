"""The port's two-view pipeline (SuperPoint + LightGlue inference) against
the JAX package's on the same seeded images and converted weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model

H, W, K = 96, 128, 48
CONF = {
    "extractor": {"name": "superpoint", "channels": [8, 8, 16, 16], "head_channels": 32,
                  "descriptor_dim": 32, "max_num_keypoints": K, "detection_threshold": 0.0},
    "matcher": {"name": "lightglue", "n_layers": 2, "descriptor_dim": 64, "input_dim": 32,
                "num_heads": 2, "filter_threshold": 0.0},
}


def _data(seed=0, B=2):
    """View 1 is view 0 plus faint noise, so random weights still match."""
    rng = np.random.default_rng(seed)
    img0 = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(scale=1e-3, size=img0.shape), 0, 1).astype(np.float32)
    size = np.asarray([[W, H]] * B, np.float32)
    return {"view0": {"image": img0, "image_size": size},
            "view1": {"image": img1, "image_size": size}}


def _to(data, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


@pytest.fixture(scope="module")
def runs():
    data = _data()
    pipe_j = jax_get_model("two_view_pipeline").from_conf(
        {**CONF, "matcher": {**CONF["matcher"], "checkpointed": False}})
    dj = _to(data, jnp.asarray)
    params = jax.jit(pipe_j.init, static_argnames="method")(
        {"params": jax.random.key(0)}, dj, method="initialize")
    params = {"params": params["params"]}
    ref = jax.jit(pipe_j.apply)(params, dj)
    pipe_t = get_model("two_view_pipeline").from_conf(CONF, device="cpu").eval()
    pipe_t.load_state_dict(from_jax_params(params["params"], "two_view_pipeline", num_heads=2))
    with torch.no_grad():
        out = pipe_t(_to(data, torch.from_numpy))
    return {k: np.asarray(v) for k, v in ref.items()}, out, pipe_t, data


def test_pipeline_matches_jax(runs):
    ref, out, _, _ = runs
    assert set(out) == set(ref)
    for i in "01":
        np.testing.assert_array_equal(out[f"keypoints{i}"].numpy(), ref[f"keypoints{i}"])
        np.testing.assert_array_equal(out[f"keypoint_mask{i}"].numpy(), ref[f"keypoint_mask{i}"])
        np.testing.assert_allclose(out[f"descriptors{i}"].numpy(), ref[f"descriptors{i}"],
                                   atol=2e-5)
    # f32 convs and matmuls summed in another order
    np.testing.assert_allclose(out["log_assignment"].numpy(), ref["log_assignment"],
                               atol=2e-4, rtol=1e-5)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k])
    np.testing.assert_allclose(out["matching_scores0"].numpy(), ref["matching_scores0"],
                               atol=1e-5)
    assert (out["matches0"] >= 0).sum() >= 5  # the comparison is not vacuous


def test_pipeline_output_contract(runs):
    _, out, _, _ = runs
    B = 2
    assert out["keypoints0"].shape == (B, K, 2) and out["descriptors1"].shape == (B, K, 32)
    assert out["log_assignment"].shape == (B, K + 1, K + 1)
    assert out["matches0"].dtype == out["matches1"].dtype == torch.int32
    m0, m1 = out["matches0"].long(), out["matches1"].long()
    valid = m0 >= 0
    back = torch.gather(m1, 1, m0.clamp(min=0))
    assert (back[valid] == torch.arange(K).expand(B, K)[valid]).all()


def test_stacked_extraction_equals_per_view(runs):
    """`batch_extraction` runs both views as one batch; per-view extraction
    gives the same prediction."""
    _, out, pipe_t, data = runs
    per_view = get_model("two_view_pipeline").from_conf(
        {**CONF, "batch_extraction": False}, device="cpu").eval()
    per_view.load_state_dict(pipe_t.state_dict())
    with torch.no_grad():
        out2 = per_view(_to(data, torch.from_numpy))
    for k in out:
        torch.testing.assert_close(out2[k], out[k], atol=1e-5, rtol=1e-5)
