"""The conv-study kernels of the port (`ops/cuda_conv3x3.py`): both plain
versions against `jax.lax.conv_general_dilated` with the prototype scripts'
dimension numbers (the prototypes' own reference), the packed weights
against the N-packed script's `wpack`, the wrappers' dispatch and contract,
and the two tools on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu_torch.ops import _build, cuda_conv3x3
from gluefactory_tpu_torch.scripts_dev import conv_study, profile_npack, profile_stream_conv

PLAINS = {"stream": cuda_conv3x3.stream_conv3x3_plain, "npack": cuda_conv3x3.npack_conv3x3_plain}
WRAPPERS = {"stream": cuda_conv3x3.stream_conv3x3, "npack": cuda_conv3x3.npack_conv3x3}
# an even size, an odd one (zero ring and partial tiles), and C_out = 128
SHAPES = [((2, 16, 24, 64), 64), ((1, 7, 9, 64), 64), ((1, 5, 11, 64), 128)]
# f32: the same f32 products summed in another order
F32_ATOL = 1e-4


def _inputs(shape, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    w = rng.normal(0, 0.05, (3, 3, shape[-1], co)).astype(np.float32)
    return x, w


def _xla_conv(x, w):
    return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("form", ["stream", "npack"])
@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_matches_xla_conv_f32(form, shape, co):
    x, w = _inputs(shape, co)
    want = np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(w)))
    got = PLAINS[form](torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["stream", "npack"])
@pytest.mark.parametrize("shape,co", SHAPES[:2])
def test_plain_matches_xla_conv_bf16(form, shape, co):
    """Within twice the gap bf16 rounding alone opens (the plain version in
    bf16 against the same in f32 on the same bf16 inputs), plus one bf16
    step at the largest output for a sum in another order that flips a
    rounding."""
    x, w = _inputs(shape, co, seed=1)
    want = np.asarray(_xla_conv(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(w).astype(jnp.bfloat16)).astype(jnp.float32))
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    got = PLAINS[form](xt, wt)
    assert got.dtype == torch.bfloat16
    f32 = PLAINS[form](xt.float(), wt.float()).numpy()
    got = got.float().numpy()
    tol = 2 * np.abs(got - f32).max() + conv_study.bf16_step(np.abs(f32).max())
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("co", [64, 128])
def test_pack_row_taps_is_the_scripts_wpack(co):
    """Bit for bit the N-packed script's construction, in bf16."""
    _, w = _inputs((1, 1, 1, 64), co, seed=2)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    want = jnp.concatenate([wj[dy].reshape(3 * 64, co) for dy in range(3)], axis=-1)
    got = cuda_conv3x3.pack_row_taps(torch.from_numpy(w).to(torch.bfloat16))
    assert tuple(got.shape) == (192, 3 * co) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape,co", SHAPES)
def test_the_two_plain_versions_agree(shape, co):
    """f32: the same products in another order. bf16: each rounds its own
    f32 sum once, so they differ by at most one bf16 step."""
    x, w = (torch.from_numpy(a) for a in _inputs(shape, co, seed=3))
    a, b = PLAINS["stream"](x, w), PLAINS["npack"](x, w)
    torch.testing.assert_close(a, b, atol=F32_ATOL, rtol=0)
    a16, b16 = PLAINS["stream"](x.bfloat16(), w.bfloat16()), PLAINS["npack"](x.bfloat16(), w.bfloat16())
    assert (a16.float() - b16.float()).abs().max() <= conv_study.bf16_step(float(a.abs().max()))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("kernel loaded for a CPU tensor"))
    cuda_conv3x3.reset_launches()
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs((1, 6, 10, 64), 64, seed=4))
    for form in ("stream", "npack"):
        torch.testing.assert_close(WRAPPERS[form](x, w), PLAINS[form](x, w), rtol=0, atol=0)
    assert cuda_conv3x3.launches == {"stream_conv3x3": 0, "npack_conv3x3": 0}


def _never(*args, **kwargs):
    raise AssertionError("plain version used on the kernel path")


def test_kernel_device_never_falls_back(monkeypatch):
    """A tensor that dispatches to the kernel gets the kernel or an error."""
    def no_build(name):
        raise RuntimeError(f"CUDA kernel build failed: {name}")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(cuda_conv3x3, "uses_kernel", lambda device: True)
    for form in ("stream", "npack"):
        monkeypatch.setattr(cuda_conv3x3, f"{form}_conv3x3_plain", _never)
    x, w = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16), torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    for form in ("stream", "npack"):
        with pytest.raises(RuntimeError, match="build failed"):
            WRAPPERS[form](x, w)


@pytest.mark.parametrize("form", ["stream", "npack"])
def test_wrappers_refuse_what_the_kernels_do_not_take(form):
    fn = WRAPPERS[form]
    bf = torch.bfloat16
    with pytest.raises(TypeError, match="bfloat16"):
        fn(torch.zeros(1, 4, 4, 64), torch.zeros(3, 3, 64, 64))
    with pytest.raises(ValueError, match="multiples of 64"):
        fn(torch.zeros(1, 4, 4, 32, dtype=bf), torch.zeros(3, 3, 32, 64, dtype=bf))
    with pytest.raises(ValueError, match="multiples of 64"):
        fn(torch.zeros(1, 4, 4, 64, dtype=bf), torch.zeros(3, 3, 64, 96, dtype=bf))
    with pytest.raises(ValueError, match="does not fit"):
        fn(torch.zeros(1, 4, 4, 64, dtype=bf), torch.zeros(3, 3, 128, 64, dtype=bf))
    with pytest.raises(ValueError, match="NHWC"):
        fn(torch.zeros(4, 4, 64, dtype=bf), torch.zeros(3, 3, 64, 64, dtype=bf))


@pytest.mark.parametrize("ci,resident,stages,nbytes", [
    (64, True, 6, 201928),    # 72 KB of weights, 2 x 6 stages of 9 KB, staging, barriers
    (128, True, 3, 220360),   # 144 KB of weights, 2 x 3 stages
    (192, False, 1, 183496),  # each stage carries its K atom's 72 KB of weights
    (512, False, 1, 183496),
])
def test_npack_shared_memory_need(ci, resident, stages, nbytes):
    """Both kernels' shared memory (csrc/conv3x3_tile.cuh::make_plan): the
    weights stay resident while they fit beside a stage per pipeline; every
    C_in fits a block's 227 KiB, so both wrappers take every multiple of 64."""
    plan = cuda_conv3x3.shared_plan(ci)
    assert plan == {"resident": resident, "stages": stages,
                    "stage_bytes": 9216 if resident else 9216 + 73728, "bytes": nbytes}
    assert plan["bytes"] <= _build.MAX_SHARED_BYTES
    bf = torch.bfloat16
    for form in ("stream", "npack"):
        out = WRAPPERS[form](torch.zeros(1, 4, 4, ci, dtype=bf), torch.zeros(3, 3, ci, 64, dtype=bf))
        assert tuple(out.shape) == (1, 4, 4, 64)


@pytest.mark.parametrize("H,rows", [(1, 1), (64, 64), (65, 67), (130, 134), (1024, 1054)])
def test_input_rows_of_a_column_strip(H, rows):
    """Each 64-row strip loads its rows and its halo rows that lie inside
    the image (1 above unless first, 1 below unless last)."""
    assert cuda_conv3x3.STRIP_ROWS == 64
    assert cuda_conv3x3.input_rows(H) == rows


def test_bound_at_the_conv1b_shape():
    """2.147 GB of input and output at 3.35 TB/s (0.641 ms) is above the
    6.18e11 FLOP at 989 TFLOP/s (0.625 ms)."""
    ms, by = conv_study.bound(conv_study.SHAPE)
    assert by == "bytes" and ms == pytest.approx(0.6410, abs=1e-4)


def test_inputs_are_the_prototypes():
    """One image at a time draws the numbers the prototypes draw at once."""
    shape = (2, 3, 5, 64)
    x, w = conv_study.make_inputs(shape, torch.device("cpu"))
    rng = np.random.default_rng(0)
    want_x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).to(torch.bfloat16)
    want_w = torch.from_numpy(rng.normal(0, 0.05, (3, 3, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(x, want_x) and torch.equal(w, want_w)


@pytest.mark.parametrize("tool,key", [(profile_stream_conv, "stream_ms"), (profile_npack, "npack_ms")])
def test_tool_runs_on_cpu(tool, key, capsys):
    res = tool.main(device="cpu", shape=(1, 12, 20, 64))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[-1] == res
    for before, after in zip(lines, lines[1:]):  # one line that grows
        assert set(before) <= set(after)
    assert {"lib_ms", "maxdiff", key, "plain_ms", "bound_ms", "card"} <= set(res)
    assert res["card"] == "cpu" and res["lib_ms"] is None and res[key] is None  # no device time
    assert 0 <= res["maxdiff"] <= res["tol"]
    assert res["kernel_calls"] == 1
