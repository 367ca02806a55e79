"""The port's open SuperPoint (`variant: open`, `superpoint_open`) against
the JAX package's on the same seeded images and the same weights: torch's
seeded init with random BatchNorm statistics in rpautrat's layout, taken
into the JAX package by its `convert_superpoint_open` (so that layout is
the official one) and back by `from_jax_params`.

Tolerances: 1e-4 absolute on the dense maps, scores and descriptors
(float32 sums in another order; by the batch's statistics in training);
keypoints and masks equal; the running statistics within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.compat.torch_conversion import convert_superpoint_open
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.ops import pallas_detect
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors.superpoint import SuperPoint
from gluefactory_tpu_torch.ops import cuda_detect
from gluefactory_tpu_torch.ops.grid_sample import sample_descriptors

TOL = 1e-4
CONF = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
        "max_num_keypoints": 48, "detection_threshold": 0.0, "dense_outputs": True}
H, W = 64, 96


def _models(conf=CONF, seed=0):
    torch.manual_seed(seed)
    port = get_model("superpoint_open").from_conf(conf, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
        port.detector[1].bn.weight.mul_(5.0)  # spread logits: no near-ties among the top scores
    sd = port.state_dict()
    params, stats = convert_superpoint_open({k: v.numpy() for k, v in sd.items()})
    back = from_jax_params(params, "superpoint_open", batch_stats=stats)
    assert set(back) == set(sd)
    assert all("num_batches" in k or torch.equal(v, sd[k]) for k, v in back.items())
    return jax_get_model("superpoint_open").from_conf(conf), {"params": params, "batch_stats": stats}, port


def _image(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (2, H, W, 1)).astype(np.float32)


def _compare(out, ref):
    for k in ("keypoint_mask", "keypoints"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert out["keypoint_mask"].all()
    for k in ("keypoint_scores", "descriptors", "dense_descriptors", "dense_score_map"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL, rtol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def eval_run():
    model_j, variables, port = _models()
    img = _image()
    ref = jax.jit(model_j.apply)(variables, {"image": jnp.asarray(img)})
    with torch.no_grad():
        out = port({"image": torch.from_numpy(img)})
    return ref, out, port


def test_eval_matches_jax(eval_run):
    ref, out, _ = eval_run
    _compare(out, ref)


def test_descriptors_sampled_at_the_cell_centre(eval_run):
    """The open variant samples at u / 8 - 0.5 (the cell's geometric
    centre); the vanilla legacy offset would give other descriptors."""
    ref, out, _ = eval_run
    dense = out["dense_descriptors"]
    centre = sample_descriptors(out["keypoints"], dense, stride=8, legacy_offset=False)
    legacy = sample_descriptors(out["keypoints"], dense, stride=8, legacy_offset=True)
    torch.testing.assert_close(out["descriptors"], centre)
    assert float(np.abs(legacy.numpy() - np.asarray(ref["descriptors"])).max()) > 10 * TOL


@pytest.mark.parametrize("freeze", [False, True])
def test_train_batch_norm_matches_jax(freeze):
    """`train=True`: the backbone and the 3x3 heads by the batch unless
    `freeze_batch_normalization`, the 1x1 heads by their running
    statistics, and the running statistics after the call equal JAX's
    mutated `batch_stats` (unmoved when frozen)."""
    conf = {**CONF, "freeze_batch_normalization": freeze}
    model_j, variables, port = _models(conf, seed=1)
    img = _image(1)
    ref, updates = jax.jit(lambda v, d: model_j.apply(v, d, train=True, mutable=["batch_stats"]))(
        variables, {"image": jnp.asarray(img)})
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        out = port({"image": torch.from_numpy(img)}, train=True)
    _compare(out, ref)
    want = from_jax_params(variables["params"], "superpoint_open", batch_stats=updates["batch_stats"])
    moved = set()
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, rtol=1e-5, err_msg=k)
            if not torch.equal(v, before[k]):
                moved.add(k.rsplit(".", 2)[0])
    expected = set() if freeze else {f"backbone.{i}.{j}" for i in range(4) for j in range(2)} | {
        "detector.0", "descriptor.0"}
    assert moved == expected


def test_fused_backbone_raises_with_open():
    with pytest.raises(ValueError, match="vanilla"):
        get_model("superpoint_open").from_conf({**CONF, "fused_backbone": True}, device="cpu")


def test_fused_detect_routes_as_jax(monkeypatch):
    """`fused_detect` is not gated on the variant: under each package's test
    hook both take the fused decode (the port's plain version of
    `csrc/nms_tile_reduce.cu` on the CPU, JAX's Pallas kernel interpreted)
    and give the same keypoints."""
    monkeypatch.setattr(pallas_detect, "FORCE_INTERPRET", True)
    monkeypatch.setattr(cuda_detect, "FORCE_FUSED", True)
    calls = []
    detect = cuda_detect.detect_keypoints
    monkeypatch.setattr("gluefactory_tpu_torch.models.extractors.superpoint.detect_keypoints",
                        lambda *a, **k: calls.append(1) or detect(*a, **k))
    conf = {**CONF, "fused_detect": True, "nms_radius": 3}
    model_j, variables, port = _models(conf, seed=2)
    img = _image(2)
    size = np.asarray([[90.0, 60.0], [96.0, 64.0]], np.float32)
    ref = model_j.apply(variables, {"image": jnp.asarray(img), "image_size": jnp.asarray(size)})
    with torch.no_grad():
        out = port({"image": torch.from_numpy(img), "image_size": torch.from_numpy(size)})
    assert calls == [1]
    _compare(out, ref)


def test_official_layout_loads_strict():
    """rpautrat's key names (`backbone.{i}.{0,1}.{conv,bn}`, `detector`,
    `descriptor`) at the published widths load with strict=True, with or
    without `num_batches_tracked`."""
    names = [f"backbone.{i}.{j}" for i in range(4) for j in range(2)]
    names += ["detector.0", "detector.1", "descriptor.0", "descriptor.1"]
    model = get_model("superpoint_open").from_conf({}, device="cpu")
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    official = {}
    for n in names:
        for leaf in ("conv.weight", "conv.bias", "bn.weight", "bn.bias", "bn.running_mean",
                     "bn.running_var"):
            official[f"{n}.{leaf}"] = torch.rand(shapes[f"{n}.{leaf}"])
    assert shapes["detector.1.conv.weight"] == (65, 256, 1, 1)
    assert shapes["descriptor.1.conv.weight"] == (256, 256, 1, 1)
    assert shapes["backbone.3.1.conv.weight"] == (128, 128, 3, 3)
    assert isinstance(model, SuperPoint)
    model.load_state_dict(official, strict=True)
    with_counts = {**official, **{f"{n}.bn.num_batches_tracked": torch.tensor(0) for n in names}}
    model.load_state_dict(with_counts, strict=True)
    assert set(model.state_dict()) == set(with_counts)
