"""The port's int8 serving options against the JAX package's on the CPU:
`ops/int8_conv.py` (quantization, the conv's plain version, the pool, the
similarity), `ops/s2d_conv.py`, SuperPoint's `quantize: int8` and
`s2d_block1`, and LightGlue's `int8_similarity` in the dense forward and
the serving path. Same seeded inputs, the JAX functions jitted, the weights
through `from_jax_params`; narrow widths (SuperPoint [8, 8, 16, 16], head
32, 64 x 48 images; LightGlue D = 32, 2 layers)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu.models.matchers.lightglue_serving import make_serving_fn as jax_serving_fn
from gluefactory_tpu.ops import int8_conv as J
from gluefactory_tpu.ops import s2d_conv as JS
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.matchers.lightglue_serving import make_serving_fn
from gluefactory_tpu_torch.ops import int8_conv as I
from gluefactory_tpu_torch.ops import s2d_conv as S

torch.set_num_threads(1)

SP = {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 32,
      "max_num_keypoints": 32, "detection_threshold": 0.0, "dense_outputs": True}
H, W = 48, 64
LG = {"n_layers": 2, "input_dim": 32, "descriptor_dim": 32, "num_heads": 2, "flash": False,
      "checkpointed": False, "filter_threshold": 0.01}

jq_weight = jax.jit(J.quantize_weight)
jq_act = jax.jit(J.quantize_activation)
jpool = jax.jit(J.int8_max_pool)


@jax.jit
def j_acc(x8, w8):
    return jax.lax.conv_general_dilated(x8, w8, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)


def j_conv(relu, requant):
    return jax.jit(lambda x8, s, w, b: J.int8_conv(x8, s, w, b, relu=relu, requant=requant))


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer(seed, B, h, w, cin, cout, k, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, h, w, cin)) * scale).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, b


LAYERS = [(2, 13, 11, 1, 8, 3), (2, 12, 10, 16, 24, 3), (1, 7, 9, 32, 65, 1), (2, 6, 8, 32, 32, 1)]


@pytest.mark.parametrize("shape", [(3, 3, 1, 8), (3, 3, 16, 24), (1, 1, 32, 65)])
def test_quantize_weight_bit_equal(shape):
    w = (np.random.default_rng(0).standard_normal(shape) * 0.1).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel: the 1e-12 floor
    w8j, swj = jq_weight(w)
    w8t, swt = I.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(w8t.numpy(), np.asarray(w8j))
    np.testing.assert_array_equal(swt.numpy(), np.asarray(swj))  # exact


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_activation_bit_equal(dtype):
    x = (np.random.default_rng(1).standard_normal((2, 9, 7, 3)) * 5).astype(dtype)
    x8j, sj = jq_act(x)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16 if dtype != np.float32 else torch.float32)
    x8t, st = I.quantize_activation(xt)
    assert st.dtype == torch.float32 and st.dim() == 0
    np.testing.assert_array_equal(x8t.numpy(), np.asarray(x8j))
    assert st.item() == float(sj)  # exact


@pytest.mark.parametrize("layer", LAYERS)
def test_conv_accumulators_equal(layer):
    """The plain version's int32 sums against lax.conv's int32 result: exact."""
    x, w, _ = _layer(2, *layer)
    x8, _ = jq_act(x)
    w8, _ = jq_weight(w)
    acc_t = I.conv_accumulators(_t(x8), I.pack_weight(torch.from_numpy(w)))
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(j_acc(x8, w8)))


@pytest.mark.parametrize("layer", LAYERS)
def test_int8_conv_requant_codes_equal(layer):
    x, w, b = _layer(3, *layer)
    x8, s = jq_act(x)
    y8j, syj = j_conv(True, True)(x8, s, w, b)
    y8t, syt = I.int8_conv(_t(x8), _t(s), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(y8t.numpy(), np.asarray(y8j))  # the codes: exact
    # the scale: XLA fuses y = acc * (s_x s_w) + b into an FMA and reassociates
    # the scale products; the port rounds in the source's order: 2 ulps
    np.testing.assert_array_max_ulp(syt.numpy(), np.asarray(syj), maxulp=2)


@pytest.mark.parametrize("layer", LAYERS)
def test_int8_conv_bf16_within_one_ulp(layer):
    x, w, b = _layer(4, *layer)
    x8, s = jq_act(x)
    yj = np.asarray(j_conv(False, False)(x8, s, w, b).astype(jnp.float32))
    yt = I.int8_conv(_t(x8), _t(s), torch.from_numpy(w), torch.from_numpy(b), relu=False,
                     requant=False)
    assert yt.dtype == torch.bfloat16
    ulp = np.maximum(np.abs(yj), 1e-30) * 2.0 ** -7  # one bf16 step at most
    assert (np.abs(yt.float().numpy() - yj) <= ulp).all()


@pytest.mark.parametrize("shape", [(1, 8, 8, 4), (2, 7, 9, 3), (1, 1, 5, 2)])
def test_int8_max_pool(shape):
    x8 = np.random.default_rng(5).integers(-127, 128, shape).astype(np.int8)
    np.testing.assert_array_equal(I.int8_max_pool(torch.from_numpy(x8)).numpy(),
                                  np.asarray(jpool(x8)))


@pytest.mark.parametrize("hw", [(12, 10), (13, 11)])
def test_pool_in_the_conv_equals_the_pool_after(hw):
    """`pool=True` (the kernel fuses it) is the int8 pool of the unpooled
    codes, at the unpooled layer's scale, odd sizes included."""
    x, w, b = _layer(6, 2, *hw, 8, 8, 3)
    x8, s = I.quantize_activation(torch.from_numpy(x))
    pw = I.pack_weight(torch.from_numpy(w))
    q, sq = I.int8_conv(x8, s, pw, torch.from_numpy(b))
    qp, sp = I.int8_conv(x8, s, pw, torch.from_numpy(b), pool=True)
    assert torch.equal(qp, I.int8_max_pool(q)) and torch.equal(sp, sq)


def test_per_tensor_scale_over_the_batch():
    """One activation scale over both images: the dim image's codes change
    when a bright image joins its batch, in both packages alike."""
    rng = np.random.default_rng(7)
    dim = (rng.uniform(0, 0.1, (1, H, W, 1))).astype(np.float32)
    bright = (rng.uniform(0, 1.0, (1, H, W, 1))).astype(np.float32)
    batch = np.concatenate([dim, bright])
    x8j, sj = jq_act(batch)
    x8t, st = I.quantize_activation(torch.from_numpy(batch))
    np.testing.assert_array_equal(x8t.numpy(), np.asarray(x8j))
    alone, s_alone = I.quantize_activation(torch.from_numpy(dim))
    assert st.item() == float(sj) and st.item() > 5 * s_alone.item()
    assert not torch.equal(alone[0], x8t[0])
    assert x8t[0].abs().max() < 20 and alone.abs().max() == 127


# -- space-to-depth ---------------------------------------------------------


def test_space_to_depth_and_phase_kernels_equal():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(S.space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(JS.space_to_depth(x)))
    w3 = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    for py in range(2):
        for px in range(2):
            np.testing.assert_array_equal(S._phase_kernel(torch.from_numpy(w3), py, px).numpy(),
                                          np.asarray(JS._phase_kernel(w3, py, px)))


def test_vgg_block1_s2d_against_jax_and_the_plain_block():
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 16, 20, 1)).astype(np.float32)
    wa, ba = (rng.standard_normal((3, 3, 1, 8)) * 0.5).astype(np.float32), rng.standard_normal(8).astype(np.float32) * 0.1
    wb, bb = (rng.standard_normal((3, 3, 8, 8)) * 0.2).astype(np.float32), rng.standard_normal(8).astype(np.float32) * 0.1
    ref = np.asarray(jax.jit(JS.vgg_block1_s2d)(x, wa, ba, wb, bb))
    t = [torch.from_numpy(a) for a in (x, wa, ba, wb, bb)]
    out = S.vgg_block1_s2d(*t).numpy()
    # f32 sums in another order
    np.testing.assert_allclose(out, ref, atol=1e-5)
    xc = t[0].permute(0, 3, 1, 2)
    conv = lambda z, w, b: torch.relu(torch.nn.functional.conv2d(z, w.permute(3, 2, 0, 1), b, padding=1))
    plain = torch.nn.functional.max_pool2d(conv(conv(xc, t[1], t[2]), t[3], t[4]), 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out, plain.numpy(), atol=1e-5)


# -- SuperPoint -----------------------------------------------------------------


@pytest.fixture(scope="module")
def sp_params():
    model = jax_get_model("superpoint").from_conf(SP)
    image = np.random.default_rng(10).uniform(0, 1, (2, H, W, 1)).astype(np.float32)
    return jax.jit(model.init)({"params": jax.random.key(0)}, {"image": jnp.asarray(image)})


def _sp_image(seed=11):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (2, H, W, 1)).astype(np.float32)
    img[1] *= 0.3  # a dimmer second image: the batch's one scale matters
    return img


def _run_sp(params, conf, image):
    ref = jax.jit(jax_get_model("superpoint").from_conf(conf).apply)(params, {"image": jnp.asarray(image)})
    sp_t = get_model("superpoint").from_conf(conf, device="cpu").eval()
    sp_t.load_state_dict(from_jax_params(params["params"], "superpoint"), strict=True)
    with torch.no_grad():
        out = sp_t({"image": torch.from_numpy(image)})
    return {k: np.asarray(v, np.float32) for k, v in ref.items()}, {k: v.float().numpy() for k, v in out.items()}


def test_superpoint_int8_heads_bit_equal(sp_params):
    """The int8 dense pass's bf16 heads (logits, raw descriptors) against
    JAX's `_int8_dense`, jitted: every int8 code and both bf16 heads equal."""
    image = _sp_image(12)
    model = jax_get_model("superpoint").from_conf({**SP, "quantize": "int8"})
    lj, dj = jax.jit(lambda p, x: model.apply(p, x, method="_int8_dense"))(sp_params, jnp.asarray(image))
    sp_t = get_model("superpoint").from_conf({**SP, "quantize": "int8"}, device="cpu").eval()
    sp_t.load_state_dict(from_jax_params(sp_params["params"], "superpoint"), strict=True)
    with torch.no_grad():
        lt, dt = sp_t._int8_dense(torch.from_numpy(image))
    assert lt.dtype == dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(lt.permute(0, 2, 3, 1).float().numpy(), np.asarray(lj, np.float32))
    np.testing.assert_array_equal(dt.permute(0, 2, 3, 1).float().numpy(), np.asarray(dj, np.float32))


def test_superpoint_int8_against_jax(sp_params):
    """The whole forward: the decode runs on the bf16 heads, where the two
    packages' bf16 softmax and norm round apart by one bf16 step (their
    inputs are equal, above). Keypoints are not compared: on this flat
    random-weight score map one step reorders the top-k."""
    ref, out = _run_sp(sp_params, {**SP, "quantize": "int8"}, _sp_image())
    np.testing.assert_allclose(out["dense_score_map"], ref["dense_score_map"], atol=2.5e-4)
    np.testing.assert_allclose(out["dense_descriptors"], ref["dense_descriptors"], atol=2 ** -8)
    assert out["keypoints"].shape == ref["keypoints"].shape == (2, SP["max_num_keypoints"], 2)


def test_superpoint_int8_routes_every_conv():
    """The int8 dense pass calls the conv 12 times (8 backbone, 4 heads), 3
    of them pooled, and never the float convs."""
    sp_t = get_model("superpoint").from_conf({**SP, "quantize": "int8"}, device="cpu").eval()
    calls = []
    real = I.int8_conv
    import gluefactory_tpu_torch.models.extractors.superpoint as sp_mod
    sp_mod.int8_conv = lambda *a, **k: calls.append(k.get("pool", False)) or real(*a, **k)
    float_calls = []
    for m in sp_t.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(lambda *a: float_calls.append(1))
    try:
        with torch.no_grad():
            sp_t({"image": torch.from_numpy(_sp_image())})
    finally:
        sp_mod.int8_conv = real
    assert len(calls) == 12 and sum(calls) == 3 and not float_calls


def test_superpoint_int8_against_its_float_path(sp_params):
    """int8 against f32 in the port alone at `tests/test_int8.py`'s bounds."""
    image = _sp_image(12)
    _, fp = _run_sp(sp_params, SP, image)
    _, q = _run_sp(sp_params, {**SP, "quantize": "int8"}, image)
    assert np.corrcoef(fp["dense_score_map"].ravel(), q["dense_score_map"].ravel())[0, 1] > 0.99
    cos = (fp["dense_descriptors"] * q["dense_descriptors"]).sum(-1)
    assert cos.min() > 0.98 and cos.mean() > 0.995


def test_superpoint_int8_train_runs_the_float_path(sp_params):
    image = torch.from_numpy(_sp_image(13))
    outs = []
    for conf in ({**SP, "quantize": "int8"}, SP):
        sp_t = get_model("superpoint").from_conf(conf, device="cpu")
        sp_t.load_state_dict(from_jax_params(sp_params["params"], "superpoint"))
        with torch.no_grad():
            outs.append(sp_t._forward({"image": image}, train=True))
    for k in ("keypoints", "keypoint_scores", "descriptors"):
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_superpoint_s2d_block1_against_jax(sp_params, fused):
    """`s2d_block1`, alone and beside `fused_backbone` (whose blocks run the
    kernel's plain version on the CPU), against JAX's s2d SuperPoint."""
    conf = {**SP, "s2d_block1": True, "fused_backbone": fused}
    ref, out = _run_sp(sp_params, {**SP, "s2d_block1": True}, _sp_image(14))
    _, out = _run_sp(sp_params, conf, _sp_image(14))
    # f32 convs summed in another order, as tests/test_torch_superpoint.py
    np.testing.assert_allclose(out["dense_score_map"], ref["dense_score_map"], atol=1e-5)
    np.testing.assert_allclose(out["dense_descriptors"], ref["dense_descriptors"], atol=5e-5)
    np.testing.assert_array_equal(out["keypoints"], ref["keypoints"])


def test_s2d_block1_odd_size_runs_the_plain_block(sp_params):
    image = _sp_image(15)[:, :-1, :-8]  # 47 x 56: H odd
    _, plain = _run_sp(sp_params, SP, image)
    _, s2d = _run_sp(sp_params, {**SP, "s2d_block1": True}, image)
    for k in plain:
        np.testing.assert_array_equal(s2d[k], plain[k], err_msg=k)


@pytest.mark.parametrize("key,value", [("quantize", "int8"), ("s2d_block1", True)])
def test_open_variant_raises(key, value):
    with pytest.raises(ValueError, match="vanilla"):
        get_model("superpoint").from_conf({**SP, "variant": "open", key: value}, device="cpu")


def test_unknown_quantize_raises():
    with pytest.raises(ValueError, match="quantize"):
        get_model("superpoint").from_conf({**SP, "quantize": "int4"}, device="cpu")


# -- LightGlue ----------------------------------------------------------------------


def _lg_data(seed=16, B=2, M=40, N=36):
    rng = np.random.default_rng(seed)
    data = {"image_size0": np.full((B, 2), 100.0, np.float32),
            "image_size1": np.full((B, 2), 100.0, np.float32)}
    for i, n in (("0", M), ("1", N)):
        data[f"keypoints{i}"] = rng.uniform(0, 100, (B, n, 2)).astype(np.float32)
        data[f"descriptors{i}"] = rng.standard_normal((B, n, 32)).astype(np.float32)
        data[f"keypoint_mask{i}"] = rng.uniform(size=(B, n)) > 0.2
    return data


@pytest.fixture(scope="module")
def lg_params():
    model = jax_get_model("lightglue").from_conf(LG)
    dj = {k: jnp.asarray(v) for k, v in _lg_data().items()}
    params = jax.jit(model.init, static_argnames="method")(
        {"params": jax.random.key(1)}, dj, method="initialize")["params"]
    return jax.tree.map(np.asarray, params)


def _lg_port(params, conf):
    model = get_model("lightglue").from_conf(conf, device="cpu").eval()
    model.load_state_dict(from_jax_params(params, "lightglue", LG["num_heads"]), strict=True)
    return model


def _quant_jax(x):
    """JAX LightGlue's per-token quantization (`MatchAssignment.__call__`)."""
    s = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0
    s = jnp.maximum(s, 1e-12)
    return jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8), s[..., 0]


def test_quantize_rows_and_int8_bmm_against_jax():
    rng = np.random.default_rng(17)
    a = rng.standard_normal((2, 30, 32)).astype(np.float32)
    c = rng.standard_normal((2, 21, 32)).astype(np.float32)
    a[0, 3] = 0.0  # a zero token: the 1e-12 floor
    (qa, sa), (qc, sc) = jax.jit(_quant_jax)(a), jax.jit(_quant_jax)(c)
    qa_t, sa_t = I.quantize_rows(torch.from_numpy(a))
    qc_t, sc_t = I.quantize_rows(torch.from_numpy(c))
    np.testing.assert_array_equal(qa_t.numpy(), np.asarray(qa))
    np.testing.assert_array_equal(sa_t.numpy(), np.asarray(sa))
    scale = 1.0 / 32 ** 0.25
    isim = jax.jit(lambda x, y: jnp.einsum("bmd,bnd->bmn", x, y, preferred_element_type=jnp.int32))(qa, qc)
    ref = np.asarray(isim).astype(np.float32) * ((np.asarray(sa)[:, :, None] * np.asarray(sc)[:, None, :])
                                                 * np.float32(scale * scale))
    sim = I.int8_bmm(qa_t, qc_t, sa_t, sc_t, scale * scale)
    np.testing.assert_array_equal(sim.numpy(), ref)  # the integer sums are exact in f32


def test_lightglue_int8_similarity_against_jax(lg_params):
    data = _lg_data()
    conf = {**LG, "int8_similarity": True}
    ref = jax.jit(jax_get_model("lightglue").from_conf(conf).apply)(
        {"params": lg_params}, {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        out = _lg_port(lg_params, conf)({k: torch.from_numpy(v) for k, v in data.items()})
    want, got = np.asarray(ref["log_assignment"]), out["log_assignment"].numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    # XLA folds scale^2 into the row scales (1-ulp products), and codes at a
    # rounding boundary may move one step
    np.testing.assert_allclose(got[fin], want[fin], atol=2e-3)
    agree = (out["matches0"].numpy() == np.asarray(ref["matches0"])).mean()
    assert agree > 0.95, agree


def test_lightglue_int8_similarity_close_to_float(lg_params):
    """int8 against the float head in the port alone, at `tests/test_int8.py`'s
    bounds."""
    data = {k: torch.from_numpy(v) for k, v in _lg_data(18).items()}
    with torch.no_grad():
        fp = _lg_port(lg_params, LG)(data)
        q = _lg_port(lg_params, {**LG, "int8_similarity": True})(data)
    assert (fp["matches0"] == q["matches0"]).float().mean() > 0.95
    a, b = fp["log_assignment"].numpy(), q["log_assignment"].numpy()
    err = np.abs(a - b)[np.isfinite(a) & np.isfinite(b) & (a > -20)]
    assert err.max() < 0.5 and err.mean() < 0.05


def test_lightglue_serving_int8_similarity_against_jax(lg_params):
    conf = {**LG, "int8_similarity": True, "depth_confidence": 0.95, "width_confidence": -1.0}
    params = {k: dict(v) for k, v in lg_params.items()}
    params["token_confidence_0"] = {"token": {"kernel": np.zeros((32, 1), np.float32),
                                              "bias": np.full(1, 20.0, np.float32)}}  # exit after layer 1
    data = _lg_data(19)
    fn = jax_serving_fn(jax_get_model("lightglue").from_conf(conf), {"params": params})
    ref = fn({k: jnp.asarray(v) for k, v in data.items()})
    model = _lg_port(params, conf)
    seen = []
    real = model.log_assignment[0].forward
    model.log_assignment[0].forward = lambda *a: seen.append(1) or real(*a)
    with torch.no_grad():
        out = make_serving_fn(model)({k: torch.from_numpy(v) for k, v in data.items()})
    assert out["exit_layer"].tolist() == np.asarray(ref["exit_layer"]).tolist() == [0, 0]
    assert seen  # the exit layer's int8 head
    want, got = np.asarray(ref["log_assignment"]), out["log_assignment"].numpy()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=2e-3)


def test_kernel_device_never_falls_back(monkeypatch):
    """A tensor that dispatches to the kernel gets the kernel or an error:
    with the library unbuildable, `int8_conv` and `int8_bmm` raise and the
    plain versions never run."""
    from gluefactory_tpu_torch.ops import _build

    monkeypatch.setattr(I, "uses_kernel", lambda device: True)
    monkeypatch.setattr(_build, "load", lambda name: (_ for _ in ()).throw(RuntimeError(f"build failed: {name}")))

    def plain_called(*a, **k):
        raise AssertionError("plain version used on the kernel path")

    for name in ("plain_int8_conv", "plain_conv_acc", "plain_int8_bmm"):
        monkeypatch.setattr(I, name, plain_called)
    x8 = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = I.pack_weight(torch.ones(3, 3, 16, 8))
    with pytest.raises(RuntimeError, match="build failed: int8_conv"):
        I.int8_conv(x8, torch.tensor(1.0), w, None)
    q = torch.zeros(1, 3, 16, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="build failed: int8_conv"):
        I.int8_bmm(q, q, torch.ones(1, 3), torch.ones(1, 3), 1.0)
    with pytest.raises(ValueError, match="multiple of 16"):
        I.int8_bmm(q[..., :8], q[..., :8], torch.ones(1, 3), torch.ones(1, 3), 1.0)


def test_dense_pass_work_at_bench_shapes():
    """The bound's operation count: 177.8 GOP an image of 1024^2 (conv1b
    77.3, block 2 38.7, block 3 29.0, block 4 9.7, the heads 22.0, conv1a
    1.2)."""
    work = I.dense_pass_work(1, 1024, 1024, [64, 64, 128, 128], 256, 256)
    gop = {k: v["ops"] / 1e9 for k, v in work.items()}
    assert round(gop["conv1b"], 1) == 77.3 and round(gop["conv1a"], 1) == 1.2
    assert round(gop["conv2a"] + gop["conv2b"], 1) == 38.7
    assert round(gop["conv3a"] + gop["conv3b"], 1) == 29.0
    assert round(gop["conv4a"] + gop["conv4b"], 1) == 9.7
    assert round(sum(gop[f"conv{h}{t}"] for h in "PD" for t in "ab"), 1) == 22.0
    assert round(sum(gop.values()), 1) == 177.8
    # conv1b: 1 MiB x 64 in, a quarter of that out (pooled), the weights once
    assert work["conv1b"]["bytes"] == 1024 * 1024 * 64 + 512 * 512 * 64 + 9 * 64 * 64
