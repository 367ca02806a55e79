"""The port's ALIKED against the JAX package's on the same seeded inputs and
the same weights: torch's seeded init in the official layout, taken into
the JAX package by its `convert_aliked` and back by `from_jax_params`
(SDDH alone: `zoo_params.random_variables`).

Tolerance: 1e-4 absolute on dense maps, descriptors, scores, dispersity
and refined keypoints (float32 sums in another order); keypoint masks
equal. Every model here keeps `max_num_keypoints` below its NMS survivors
at threshold 0, so every compared slot is a detection and no random fill
enters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from zoo_params import random_variables

from gluefactory_tpu.compat.torch_conversion import convert_aliked
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.extractors import aliked as jax_aliked
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors import aliked

TOL = 1e-4
OUT_KEYS = ("keypoints", "keypoint_scores", "descriptors", "score_dispersity", "score_map")


def _conv_sd(p, prefix, sd):
    sd[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["bias"]))


def test_deform_conv2d_matches_jax():
    """Offsets up to 3x the clamp (max(H, W) / 4), so that some are
    clamped and some taps land outside the map (zeros there)."""
    rng = np.random.default_rng(0)
    B, H, W, C, O = 2, 9, 11, 5, 7
    max_offset = max(H, W) / 4.0
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    offsets = (3 * max_offset * rng.uniform(-1, 1, (B, H, W, 18))).astype(np.float32)
    kernel = rng.standard_normal((3, 3, C, O)).astype(np.float32)
    assert (np.abs(offsets) > max_offset).mean() > 0.5
    want = jax.jit(jax_aliked.deform_conv2d, static_argnums=3)(x, offsets, kernel, max_offset)
    got = aliked.deform_conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(offsets).permute(0, 3, 1, 2),
                               torch.from_numpy(kernel).permute(3, 2, 0, 1), max_offset)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # taps outside the map: the clamped offsets still leave it
    ys = np.arange(H)[:, None] + np.clip(offsets[..., 0], -max_offset, max_offset) - 1
    assert (ys < -1).any() and (ys > H).any()


def test_sddh_matches_jax():
    """Keypoints within K px of every edge (the patch corner's clamp to
    [0, size - 1 - K]) and offsets that reach the clamp."""
    rng = np.random.default_rng(1)
    B, H, W, C, K, M = 1, 12, 14, 8, 3, 4
    fmap = rng.standard_normal((B, H, W, C)).astype(np.float32)
    edge = [0.2, 1.7, 2.9]
    xs = edge + [W - 1 - e for e in edge] + [6.4]
    ys = edge[::-1] + [H - 1 - e for e in edge] + [5.5]
    kpts = np.stack([np.array(xs), np.array(ys)], -1)[None].astype(np.float32)
    head = jax_aliked.SDDH(C, K, M)
    variables = random_variables(head, jnp.asarray(fmap), jnp.asarray(kpts), seed=1)
    variables["params"]["offset_conv2"]["kernel"] *= 8.0
    want = jax.jit(head.apply)(variables, jnp.asarray(fmap), jnp.asarray(kpts))
    p = variables["params"]
    sd = {}
    _conv_sd(p["offset_conv1"], "offset_conv.0", sd)
    _conv_sd(p["offset_conv2"], "offset_conv.2", sd)
    sd["sf_conv.weight"] = torch.from_numpy(np.ascontiguousarray(p["sf_conv"]["kernel"].T[:, :, None, None]))
    sd["agg_weights"] = torch.from_numpy(p["agg_weights"])
    port = aliked.SDDH(C, K, M)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(fmap), torch.from_numpy(kpts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_dkd_refine_matches_jax():
    """Keypoints in the corners (the window's zero padding) and inside."""
    rng = np.random.default_rng(2)
    H, W = 10, 12
    smap = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    kpts = np.array([[[0, 0], [W - 1, H - 1], [5, 4], [1, H - 2]],
                     [[W - 1, 0], [0, H - 1], [7, 7], [W - 2, 1]]], np.int32)
    model = jax_get_model("aliked").from_conf({"model_name": "aliked-t16", "nms_radius": 2})
    want = jax.jit(lambda k, s: model.apply({}, k, s, method="_dkd_refine"))(kpts, smap)
    port = get_model("aliked").from_conf({"model_name": "aliked-t16", "nms_radius": 2}, device="cpu")
    got = port._dkd_refine(torch.from_numpy(kpts).long(), torch.from_numpy(smap))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


CASES = {
    # an image_size smaller than the tensor, a size not a multiple of 32
    "t16": ({"model_name": "aliked-t16", "max_num_keypoints": 32, "detection_threshold": 0.0},
            (70, 90), [[80, 60], [90, 70]]),
    "n16": ({"model_name": "aliked-n16", "max_num_keypoints": 32, "detection_threshold": 0.0},
            (64, 96), [[96, 64], [90, 50]]),
}


def randomize_statistics(model, seed: int) -> None:
    """BatchNorm scales 1 + 0.1 x normal, biases and running means 0.1 x
    normal, running variances uniform in [0.5, 1.5]."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))


def _setup(name, seed=0, port_conf=None):
    """The port's model with torch's seeded init (the offset predictors'
    too, so the taps move) and random statistics; its state dict, in the
    official layout, goes to the JAX package through `convert_aliked`, and
    comes back through `from_jax_params` unchanged."""
    conf, (H, W), size = CASES[name]
    rng = np.random.default_rng(seed)
    data = {"image": rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32),
            "image_size": np.asarray(size, np.float32)}
    torch.manual_seed(seed)
    port = get_model("aliked").from_conf({**conf, **(port_conf or {})}, device="cpu")
    randomize_statistics(port, seed)
    sd = port.state_dict()
    params, stats = convert_aliked({k: v.numpy() for k, v in sd.items()}, conf["model_name"])
    back = from_jax_params(params, "aliked", batch_stats=stats)
    assert set(back) == set(sd)
    for k, v in back.items():
        assert "num_batches" in k or torch.equal(v, sd[k]), k
    port.load_state_dict(back)
    model_j = jax_get_model("aliked").from_conf(conf)
    return model_j, {"params": params, "batch_stats": stats}, port, data


def _compare(out, ref):
    np.testing.assert_array_equal(out["keypoint_mask"].numpy(), np.asarray(ref["keypoint_mask"]))
    assert out["keypoint_mask"].all()
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_eval_matches_jax(name):
    model_j, variables, port, data = _setup(name)
    ref = jax.jit(model_j.apply)(variables, {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        out = port({k: torch.from_numpy(v) for k, v in data.items()})
    _compare(out, ref)
    size = data["image_size"]
    kp = out["keypoints"].numpy()
    assert ((kp >= 0) & (kp <= size[:, None, :])).all()
    norms = np.linalg.norm(out["descriptors"].numpy(), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_forward_train_matches_jax_with_batch_statistics():
    """`train=True`: every BatchNorm by the batch, and the running
    statistics after the call equal JAX's mutated `batch_stats`;
    `freeze_batch_normalization` does not change that (the JAX model
    ignores it)."""
    model_j, variables, port, data = _setup("t16", seed=3, port_conf={"freeze_batch_normalization": True})
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    ref, updates = jax.jit(lambda v, d: model_j.apply(v, d, train=True, mutable=["batch_stats"]))(
        variables, jdata)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        out = port({k: torch.from_numpy(v) for k, v in data.items()}, train=True)
    _compare(out, ref)
    want = from_jax_params(variables["params"], "aliked", batch_stats=updates["batch_stats"])
    moved = 0
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, rtol=1e-5, err_msg=k)
            moved += int(not torch.equal(v, before[k]))
        elif "num_batches" not in k:
            assert torch.equal(v, before[k]), k
    assert moved == 2 * 8  # the 8 BatchNorms' means and variances
