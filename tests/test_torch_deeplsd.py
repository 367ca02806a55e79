"""The port's DeepLSD against the JAX package's on the same seeded inputs
and weights (`zoo_params.random_variables`, taken into the port by
`from_jax_params`), at narrow widths: GT fields and losses, both nets
(the package layout with BatchNorm by the batch and by its running
statistics), the vectoriser, the model's forward end to end, one gradient
and the package-layout state dict through the JAX package's
`convert_deeplsd`. Every JAX function is jitted once per file.

Tolerances: fields and losses 1e-6; the nets' outputs and statistics 1e-4
(float32 convolutions summed in another order); gradients 1e-5 relative to
the largest. The vectoriser is fed the same (JAX's) fields in both packages
and must give bit-equal output (the port's Hough is OpenCV's, see
`test_torch_hough.py`). End to end, the nets give the fields up to rounding,
so the test asserts that every threshold decision has a clear margin.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from zoo_params import random_variables

from gluefactory_tpu.compat.torch_conversion import convert_deeplsd
from gluefactory_tpu.models.lines import deeplsd as jd
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.lines import deeplsd as td

CH = (8, 16, 32)
SPEC = {"enc": ((8, 8), (16, 16), (16, 16), (16, 16)), "dec": ((16, 16), (8, 8), (8, 8)),
        "head": (8, 8)}
HW = (48, 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file's tests and fixtures: the suite runs 6
    workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_jax_fields = jax.jit(jd.fields_from_lines, static_argnums=(2, 3, 4))
_jax_losses = jax.jit(jd.field_losses)


def _image(seed, hw=HW, c=3):
    return np.random.default_rng(seed).uniform(0, 1, (2, *hw, c)).astype(np.float32)


def _segments(rng, B, L, h, w):
    return rng.uniform([0, 0], [w, h], (B, L, 2, 2)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- fields


def test_fields_from_lines_equal_jax():
    """Random segments, a masked and a degenerate one, a cross whose
    diagonals tie (the first segment wins), and an image with no valid
    segment; rows in several chunks."""
    rng = np.random.default_rng(0)
    h, w = 40, 56
    lines = _segments(rng, 3, 9, h, w)
    lines[0, 3] = [[10.5, 10.5], [10.5, 10.5]]  # degenerate
    lines[1, 0] = [[2.0, 20.5], [50.0, 20.5]]  # horizontal, before ...
    lines[1, 1] = [[30.5, 1.0], [30.5, 39.0]]  # ... vertical: ties on the diagonals
    lines[1, 2:] = [[0.0, 0.0], [1.0, 1.0]]
    mask = np.ones((3, 9), bool)
    mask[0, 5] = False
    mask[1, 2:] = False
    mask[2] = False
    df, ang = td.fields_from_lines(_t(lines), _t(mask), h, w, 5.0, chunk_elems=3000)
    jdf, jang = _jax_fields(jnp.asarray(lines), jnp.asarray(mask), h, w, 5.0)
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jang), rtol=0, atol=1e-6)
    # pixel (34.5, 24.5) is 4 px from both arms of the cross: the first wins
    assert float(df[1, 24, 34]) == pytest.approx(4 / 5)
    assert float(ang[1, 24, 34]) == float(np.asarray(jang)[1, 24, 34]) == 0.0
    assert float(df[2].min()) == 1.0 and float(ang[2].abs().max()) == 0.0


def test_field_losses_equal_jax():
    rng = np.random.default_rng(1)
    args = [rng.uniform(0, 1, (2, 24, 32)).astype(np.float32),
            rng.uniform(0, math.pi, (2, 24, 32)).astype(np.float32),
            rng.uniform(0, 1, (2, 24, 32)).astype(np.float32),
            rng.uniform(0, math.pi, (2, 24, 32)).astype(np.float32)]
    got = td.field_losses(*map(_t, args))
    want = _jax_losses(*map(jnp.asarray, args))
    for k in ("df", "angle", "total"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ nets


@pytest.fixture(scope="module")
def native():
    net_j = jd.DeepLSDNet(channels=CH)
    variables = random_variables(net_j, jnp.zeros((1, *HW, 3)), seed=2)
    net = td.DeepLSDNet(CH)
    net.load_state_dict(from_jax_params(variables["params"], "deeplsd"), strict=True)
    return net, net_j, variables


def test_native_net_equals_jax(native):
    net, net_j, variables = native
    img = _image(3)
    df, ang = net(_t(img))
    jdf, jang = jax.jit(net_j.apply)(variables, jnp.asarray(img))
    np.testing.assert_allclose(df.detach().numpy(), np.asarray(jdf), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ang.detach().numpy(), np.asarray(jang), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def package():
    net_j = jd.DeepLSDPackageNet(**SPEC)
    variables = random_variables(net_j, jnp.zeros((1, *HW, 1)), seed=4)
    return net_j, variables


def _package_port(variables):
    net = td.DeepLSDPackageNet(SPEC["enc"], SPEC["dec"], SPEC["head"])
    net.load_state_dict(from_jax_params(variables["params"], "deeplsd",
                                        batch_stats=variables["batch_stats"]), strict=True)
    return net


@pytest.mark.parametrize("train", [False, True])
def test_package_net_equals_jax(package, train):
    net_j, variables = package
    net = _package_port(variables)
    img = _image(5)
    df, ang = net(_t(img), train=train)
    if train:
        (jdf, jang), upd = jax.jit(lambda v, x: net_j.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(img))
        stats = from_jax_params(variables["params"], "deeplsd", batch_stats=upd["batch_stats"])
        got = net.state_dict()
        for k, v in stats.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    else:
        jdf, jang = jax.jit(lambda v, x: net_j.apply(v, x, train=False))(variables, jnp.asarray(img))
    np.testing.assert_allclose(df.detach().numpy(), np.asarray(jdf), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ang.detach().numpy(), np.asarray(jang), rtol=0, atol=1e-4)


def test_package_state_dict_through_convert_deeplsd(package):
    """A port state dict in the official layout, read by the JAX package's
    converter: the spec is found again and the forward agrees."""
    net_j, variables = package
    net = _package_port(variables)
    params, stats, spec = convert_deeplsd({k: v.numpy() for k, v in net.state_dict().items()})
    assert spec == SPEC
    img = _image(6, c=1)
    jdf, jang = jax.jit(lambda v, x: net_j.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(img))
    df, ang = net(_t(img))
    np.testing.assert_allclose(df.detach().numpy(), np.asarray(jdf), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ang.detach().numpy(), np.asarray(jang), rtol=0, atol=1e-4)


def test_native_gradient_equals_jax(native):
    """The model's loss on GT fields of planted segments, and its gradient
    with respect to every parameter, against `jax.value_and_grad`."""
    _, net_j, variables = native
    rng = np.random.default_rng(7)
    img = _image(8)
    lines = _segments(rng, 2, 6, *HW)
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    conf = {"channels": list(CH)}
    model = get_model("lines.deeplsd").from_conf(conf, device="cpu")
    model.load_state_dict(from_jax_params({"net": variables["params"]}, "deeplsd"), strict=True)
    data = {"image": _t(img), "lines": _t(lines), "line_mask": _t(mask)}
    _, losses, _ = model.forward_with_loss(data, train=True)
    loss = losses["total"].mean()
    loss.backward()

    model_j = jd.DeepLSD.from_conf(conf)

    def loss_j(p):
        _, lj, _ = model_j.apply({"params": p}, {k: jnp.asarray(v.numpy()) for k, v in data.items()},
                                 train=True, method="forward_with_loss")
        return lj["total"].mean()

    lj, gj = jax.jit(jax.value_and_grad(loss_j))({"net": variables["params"]})
    assert float(loss.detach()) == pytest.approx(float(lj), rel=1e-6)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, gj), "deeplsd")
    scale = max(float(np.abs(v.numpy()).max()) for v in want.values())
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=0, atol=1e-5 * scale, err_msg=k)


# ------------------------------------------------------------ vectoriser


def _planted_fields(seed, B=2, L=30, h=120, w=160):
    """JAX's GT fields of planted segments, with noise so that some
    candidates fail the median tests."""
    rng = np.random.default_rng(seed)
    lines = _segments(rng, B, L, h, w)
    df, ang = _jax_fields(jnp.asarray(lines), jnp.ones((B, L), bool), h, w, 5.0)
    df = np.clip(np.asarray(df) + rng.normal(0, 0.08, df.shape), 0, 1).astype(np.float32)
    ang = np.mod(np.asarray(ang) + rng.normal(0, 0.3, ang.shape), math.pi).astype(np.float32)
    return df, ang


@pytest.mark.parametrize("seed,min_length", [(9, 15.0), (10, 25.0)])
def test_vectorizer_bit_equal_to_jax(seed, min_length):
    df, ang = _planted_fields(seed)
    want = jd.lines_from_fields_host(df, ang, 40, min_length)
    got = td.lines_from_fields_host(df, ang, 40, min_length)
    assert want[2].sum() >= 10
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)


# ------------------------------------------------------------ end to end

DF_THRESH = 0.45
GAIN = 12.0
CROSS = 0.375  # the grey level at which df = DF_THRESH, between two quarters


def _identity_variables(seed=11):
    """Native-net weights that map the grey image g to df = sigmoid(GAIN g +
    b), b chosen so that df = 0.45 at g = 0.5, and the angle to sigmoid(0) x
    pi = pi / 2 everywhere: the first block and the last decoder block carry
    g on channel 0 (centre taps of 1), every other weight is 0. df =
    DF_THRESH at g = CROSS."""
    net_j = jd.DeepLSDNet(channels=CH)
    variables = random_variables(net_j, jnp.zeros((1, *HW, 1)), seed=seed)
    params = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    n = len(CH)
    for name, ci in (("_ConvBlock_0", 0), (f"_ConvBlock_{2 * n}", CH[0])):
        params[name]["Conv_0"]["kernel"][1, 1, ci, 0] = 1.0
        params[name]["Conv_1"]["kernel"][1, 1, 0, 0] = 1.0
    params[f"Conv_{n}"]["kernel"][0, 0, 0, 0] = GAIN
    params[f"Conv_{n}"]["bias"][0] = math.log(DF_THRESH / (1 - DF_THRESH)) - GAIN * CROSS
    return params


def test_forward_lines_equal_on_planted_fields():
    """The grey image is a GT field of near-vertical planted segments,
    quantised to quarters, so df takes five values, none within 0.01 of the
    threshold, and any median of them at least 0.01 away too; the angle
    field is pi / 2 in both packages. Both models give the same lines."""
    rng = np.random.default_rng(12)
    h, w = 96, 128
    x = rng.uniform(8, w - 8, (1, 10, 1))
    y = np.sort(rng.uniform(4, h - 4, (1, 10, 2)), -1)
    tilt = rng.uniform(-0.15, 0.15, (1, 10, 1)) * (y[..., 1:] - y[..., :1])
    lines = np.stack([np.concatenate([x, y[..., :1]], -1),
                      np.concatenate([x + tilt, y[..., 1:]], -1)], 2).astype(np.float32)
    gt, _ = _jax_fields(jnp.asarray(lines), jnp.ones((1, 10), bool), h, w, 5.0)
    img = (np.round(np.asarray(gt) * 4) / 4)[..., None].astype(np.float32)
    params = _identity_variables()
    conf = {"channels": list(CH), "max_num_lines": 20, "min_length": 15.0}

    model = get_model("lines.deeplsd").from_conf(conf, device="cpu")
    model.load_state_dict(from_jax_params({"net": params}, "deeplsd"), strict=True)
    with torch.no_grad():
        got = model({"image": _t(img)})
    want = jd.DeepLSD.from_conf(conf).apply({"params": {"net": params}}, {"image": jnp.asarray(img)})

    logit = math.log(DF_THRESH / (1 - DF_THRESH))
    levels = 1 / (1 + np.exp(-(GAIN * (np.arange(5) / 4 - CROSS) + logit)))
    medians = np.concatenate([levels, (levels[:, None] + levels[None])[np.triu_indices(5, 1)] / 2])
    assert np.abs(medians - DF_THRESH).min() > 0.01
    for df in (got["df"].numpy(), np.asarray(want["df"])):
        assert np.abs(df - DF_THRESH).min() > 0.01
        assert np.unique(df).size <= 5
    np.testing.assert_allclose(got["df"].numpy(), np.asarray(want["df"]), rtol=0, atol=1e-6)
    assert float(got["angle"].max()) == float(got["angle"].min()) == float(np.float32(math.pi / 2))
    valid = got["line_mask"].numpy()
    assert valid.sum() >= 6
    np.testing.assert_array_equal(valid, np.asarray(want["line_mask"]))
    np.testing.assert_array_equal(got["lines"].numpy(), np.asarray(want["lines"]))
    np.testing.assert_allclose(got["line_scores"].numpy(), np.asarray(want["line_scores"]),
                               rtol=1e-5, atol=0)


# ----------------------------------------------------------------- model


def test_model_by_name_backends_and_train_forward():
    model = get_model("lines.deeplsd").from_conf({"channels": list(CH)}, device="cpu")
    data = {"image": _t(_image(13))}
    with torch.no_grad():
        pred = model(data, train=True)
        assert set(pred) == {"df", "angle"}
        pred = model(data)
    assert pred["lines"].shape == (2, 250, 2, 2) and pred["line_mask"].dtype == torch.bool
    layout = get_model("deeplsd").from_conf({"backend": "package-layout", "package_spec": SPEC},
                                            device="cpu")
    with torch.no_grad():
        pred = layout(data)
    assert pred["df"].shape == (2, *HW) and float(pred["df"].max()) <= 1.0
    with pytest.raises(NotImplementedError):
        layout.loss(pred, {**data, "lines": torch.zeros(2, 1, 2, 2)})
    detect = get_model("lines.deeplsd").from_conf({"channels": list(CH), "detect_in_train": True},
                                                  device="cpu")
    with torch.no_grad():
        assert "lines" in detect(data, train=True)
    with pytest.raises(ImportError, match="deeplsd"):
        get_model("lines.deeplsd").from_conf({"backend": "package"}, device="cpu")
