"""The port's fused decode (`ops/cuda_detect.py`) against the JAX package's:
the plain version against the Pallas kernel in interpret mode (single and
multi chunk, bf16 input, a true size, a planted tie), `detect_keypoints`,
and the port's SuperPoint with both opt-ins against JAX's with the Pallas
kernels forced into interpret mode."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.ops import pallas_conv, pallas_detect
from gluefactory_tpu.ops.pallas_detect import detect_keypoints as jax_detect_keypoints
from gluefactory_tpu.ops.pallas_detect import fused_nms_tile_reduce, nms_tile_reduce_xla
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors.superpoint import use_fused_detect
from gluefactory_tpu_torch.ops import cuda_detect

# NMS, masks and the tile reduction are comparisons and selections: the
# plain version agrees with the kernel bit for bit (tolerance 0).


def _scores(seed, shape):
    return np.random.default_rng(seed).uniform(0.01, 1.0, shape).astype(np.float32)


def _both(scores, true_size=None, **kw):
    ts_j = None if true_size is None else jnp.asarray(true_size)
    ts_t = None if true_size is None else torch.from_numpy(true_size)
    tm, ta = fused_nms_tile_reduce(jnp.asarray(scores), ts_j, interpret=True, **kw)
    pm, pa = cuda_detect.nms_tile_reduce_plain(torch.from_numpy(scores), ts_t, **kw)
    return (np.asarray(tm), np.asarray(ta)), (pm, pa)


@pytest.mark.parametrize("case", ["single_chunk", "multi_chunk", "radius3", "true_size"])
def test_plain_matches_pallas_kernel(case):
    shape = (1, 512, 128) if case == "multi_chunk" else (2, 64, 128)  # 512 rows: two chunks
    scores = _scores(0, shape)
    kw = {"radius": 3} if case == "radius3" else {}
    ts = np.asarray([[100.0, 50.0], [128.0, 64.0]], np.float32) if case == "true_size" else None
    (tm, ta), (pm, pa) = _both(scores, ts, **kw)
    assert pm.dtype == torch.float32 and pa.dtype == torch.int32
    np.testing.assert_array_equal(pm.numpy(), tm)
    np.testing.assert_array_equal(pa.numpy(), ta)


def test_plain_matches_pallas_kernel_bf16_input():
    scores = _scores(2, (1, 64, 128))
    bf = torch.from_numpy(scores).bfloat16()
    tm, ta = fused_nms_tile_reduce(jnp.asarray(scores).astype(jnp.bfloat16), interpret=True)
    pm, pa = cuda_detect.nms_tile_reduce_plain(bf)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(tm))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ta))


def test_tie_rule_on_a_planted_tie():
    """Two equal maxima in one tile, at (dy 0, dx 2) and (dy 3, dx 1): the
    kernel's rule takes the smallest dx (arg 3 * 4 + 1); the row-major
    first max of the non-fused reduction would take arg 2."""
    scores = _scores(3, (1, 64, 128))
    scores[0, 20, 42] = scores[0, 23, 41] = 2.0  # tile (5, 10)
    (tm, ta), (pm, pa) = _both(scores)
    np.testing.assert_array_equal(pa.numpy(), ta)
    np.testing.assert_array_equal(pm.numpy(), tm)
    assert pa[0, 5, 10] == 13 and pm[0, 5, 10] == 2.0
    assert np.asarray(nms_tile_reduce_xla(jnp.asarray(scores), 4, 2, 4, 4)[1])[0, 5, 10] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detect_keypoints_matches_jax(dtype):
    scores = _scores(4, (2, 64, 128))
    ts = np.asarray([[120.0, 60.0], [128.0, 64.0]], np.float32)
    sj = jnp.asarray(scores).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    st = torch.from_numpy(scores).to(getattr(torch, dtype))
    kj, vj, okj = jax_detect_keypoints(sj, 32, 0.3, radius=3, true_size=jnp.asarray(ts),
                                       interpret=True)
    kt, vt, okt = cuda_detect.detect_keypoints(st, 32, 0.3, radius=3, true_size=torch.from_numpy(ts))
    assert vt.dtype == st.dtype
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.float().numpy(), np.asarray(vj.astype(jnp.float32)))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 10


def test_superpoint_opt_ins_match_jax(monkeypatch):
    """SuperPoint with fused_detect + fused_backbone: the port (plain
    versions on the CPU) against JAX with both Pallas kernels in interpret
    mode, the JAX package's own end-to-end check of the opt-ins."""
    conf = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
            "max_num_keypoints": 32, "detection_threshold": 0.0,
            "fused_detect": True, "fused_backbone": True}
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (2, 64, 128, 1)).astype(np.float32)
    size = np.asarray([[120.0, 60.0], [128.0, 64.0]], np.float32)
    data_j = {"image": jnp.asarray(img), "image_size": jnp.asarray(size)}
    monkeypatch.setattr(pallas_conv, "FORCE_INTERPRET", True)
    monkeypatch.setattr(pallas_detect, "FORCE_INTERPRET", True)
    monkeypatch.setattr(cuda_detect, "FORCE_FUSED", True)
    sp_j = jax_get_model("superpoint").from_conf(conf)
    variables = jax.jit(sp_j.init)({"params": jax.random.key(5)}, data_j)
    ref = sp_j.apply(variables, data_j)
    sp_t = get_model("superpoint").from_conf(conf, device="cpu").eval()
    sp_t.load_state_dict(from_jax_params(variables["params"], "superpoint"))
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(img), "image_size": torch.from_numpy(size)})
    np.testing.assert_array_equal(out["keypoint_mask"].numpy(), np.asarray(ref["keypoint_mask"]))
    np.testing.assert_array_equal(out["keypoints"].numpy(), np.asarray(ref["keypoints"]))
    # f32 convs summed in another order
    np.testing.assert_allclose(out["keypoint_scores"].numpy(), np.asarray(ref["keypoint_scores"]),
                               atol=1e-6)
    np.testing.assert_allclose(out["descriptors"].numpy(), np.asarray(ref["descriptors"]), atol=2e-5)


def test_superpoint_opt_ins_equal_the_default_path(monkeypatch):
    """On the CPU the opt-ins run the plain versions of the two kernels (the
    decode's under `FORCE_FUSED`): the same keypoints and descriptors as the
    default path, within f32 sums."""
    monkeypatch.setattr(cuda_detect, "FORCE_FUSED", True)
    conf = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
            "max_num_keypoints": 48, "detection_threshold": 0.0, "nms_radius": 3}
    torch.manual_seed(0)
    base = get_model("superpoint").from_conf(conf, device="cpu").eval()
    fused = get_model("superpoint").from_conf(
        {**conf, "fused_detect": True, "fused_backbone": True}, device="cpu").eval()
    fused.load_state_dict(base.state_dict())
    img = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (2, 96, 128, 1)).astype(np.float32))
    with torch.no_grad():
        a, b = base({"image": img}), fused({"image": img})
    torch.testing.assert_close(b["keypoints"], a["keypoints"], rtol=0, atol=0)
    torch.testing.assert_close(b["keypoint_scores"], a["keypoint_scores"], rtol=0, atol=1e-6)
    torch.testing.assert_close(b["descriptors"], a["descriptors"], rtol=0, atol=2e-5)


def _jax_takes_fused(conf, H, W) -> bool:
    """The JAX SuperPoint's condition for its fused decode at inference
    (`gluefactory_tpu/models/extractors/superpoint.py::_decode`)."""
    return bool(conf.fused_detect and conf.nms_radius >= 3
                and (jax.default_backend() == "tpu" or pallas_detect.FORCE_INTERPRET)
                and pallas_detect.fused_detect_available(H, W))


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("H", [64, 96, 268, 296, 1024])
def test_use_fused_detect_matches_jax_condition(monkeypatch, H, hook):
    """The port takes the fused decode exactly where the JAX package does,
    on the CPU with each package's test hook off and on (the card's arm, a
    CUDA tensor, is chip_smoke.py's path C). H = 268 has no TPU row chunk of
    32-256 rows; radius 7 is above the former kernel's largest, 6."""
    monkeypatch.setattr(pallas_detect, "FORCE_INTERPRET", hook)
    monkeypatch.setattr(cuda_detect, "FORCE_FUSED", hook)
    for W in (64, 128):
        scores = torch.zeros(1, H, W)
        for radius in (2, 3, 4, 7):
            for fused in (False, True):
                conf = SimpleNamespace(fused_detect=fused, nms_radius=radius)
                assert use_fused_detect(conf, scores) is _jax_takes_fused(conf, H, W), (W, radius)
    conf = SimpleNamespace(fused_detect=True, nms_radius=4)
    with torch.enable_grad():  # no gradient through the fused decode
        assert not use_fused_detect(conf, torch.zeros(1, H, 64, requires_grad=True))


def test_fused_detect_available_is_the_jax_predicate():
    for H in [*range(1, 1100, 3), 1024, 2048, 268, 296]:
        for W in (63, 64, 130):
            assert cuda_detect.fused_detect_available(H, W) == pallas_detect.fused_detect_available(H, W)


def test_superpoint_planted_ties_give_the_jax_keypoints():
    """A zero detector-head kernel and a bias with two equal largest entries,
    channels 1 and 8 (pixels (0, 1) and (1, 0) of every 8x8 cell): every
    cell holds two equal NMS survivors in one 4x4 tile, where the fused
    decode keeps (dy, dx) = (1, 0) (smallest dx) and the non-fused one
    (0, 1) (row-major first). With `fused_detect` on and no test hook, both
    packages take the non-fused decode on the CPU: identical keypoints."""
    conf = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
            "max_num_keypoints": 64, "detection_threshold": 0.0, "fused_detect": True}
    img = np.random.default_rng(8).uniform(0, 1, (1, 64, 128, 1)).astype(np.float32)
    data_j = {"image": jnp.asarray(img)}
    sp_j = jax_get_model("superpoint").from_conf(conf)
    variables = jax.jit(sp_j.init)({"params": jax.random.key(8)}, data_j)
    params = jax.tree.map(np.asarray, variables["params"])
    head = params["convPb"]["Conv_0"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.zeros_like(head["bias"])
    head["bias"][[1, 8]] = 5.0
    ref = sp_j.apply({**variables, "params": params}, data_j)
    sp_t = get_model("superpoint").from_conf(conf, device="cpu").eval()
    sp_t.load_state_dict(from_jax_params(params, "superpoint"))
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(img)})
    kp = np.asarray(ref["keypoints"])[0] - 0.5
    assert {tuple(p) for p in kp % 8} == {(1.0, 0.0)}  # x 1, y 0: the non-fused pick
    np.testing.assert_array_equal(out["keypoints"].numpy(), np.asarray(ref["keypoints"]))
    np.testing.assert_array_equal(out["keypoint_mask"].numpy(), np.asarray(ref["keypoint_mask"]))


@pytest.mark.parametrize("args,taken", [
    ((1024, 1024, 4), True),
    ((1024, 1024, 6), True),
    ((1024, 1024, 7), True),
    ((1024, 1024, 8), True),    # the kernel's largest radius
    ((1024, 1024, 9), False),   # the kernel is compiled for radii 0-8
    ((1026, 1024, 4), False),   # H not a multiple of the 4x4 tile
    ((96, 128, 3), True),
    ((96, 128, 4, 3), False),   # the halo covers 2 iterations
    ((96, 120, 4, 2, 8), True),
    ((96, 120, 4, 2, 6), False),  # a tile that is not a power of two
])
def test_detect_kernel_available(args, taken):
    assert cuda_detect.detect_kernel_available(*args) is taken


@pytest.mark.parametrize("radius", range(cuda_detect._MAX_RADIUS + 1))
def test_detect_plan_fits(radius):
    """Every radius fits a block's 227 KiB; at r <= 4 two blocks share an
    SM, with less halo than the 32 x 64 design's 3.66x at r = 4."""
    plan = cuda_detect.detect_plan(radius)
    assert plan["shared_bytes"] <= 232448
    if radius <= 4:
        assert plan["blocks_per_sm"] == 2 and plan["halo_overhead"] < 3.66
    if radius == 4:
        assert plan["region"] == (104, 104) and plan["shared_bytes"] == 91520


def test_kernel_radius_above_its_largest_raises(monkeypatch):
    """A CUDA tensor with a radius above the kernel's largest raises a
    ValueError that names the largest, before any build or launch."""
    monkeypatch.setattr(cuda_detect, "uses_kernel", lambda device: True)
    with pytest.raises(ValueError, match="radii 0 to 8"):
        cuda_detect.fused_nms_tile_reduce(torch.rand(1, 64, 64), radius=9)
