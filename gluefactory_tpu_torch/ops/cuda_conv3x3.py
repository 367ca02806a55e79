"""The conv-study kernels: wrappers of the hand-written CUDA kernels
`csrc/conv3x3_stream.cu` and `csrc/conv3x3_npack.cu`, and the plain PyTorch
version of each formulation (counterparts of the two Pallas prototypes in
`scripts_dev/profile_stream_conv.py` and `scripts_dev/profile_npack.py`).

Both compute out = conv3x3(x, w): NHWC x, HWIO w, SAME zero padding, no
bias, no ReLU; products summed in f32 and the output rounded once to x's
dtype. They differ in how they organise the work:

- streaming: nine per-tap products of the shifted input with w[dy, dx],
  summed, with no scratch;
- N-packed: the three dy taps side by side in N and the three dx taps
  folded into K, P = cat @ pack_row_taps(w) over two more rows than the
  output has, then out[i] = P[i, :, 0:C] + P[i+1, :, C:2C] + P[i+2, :, 2C:3C].

Each plain version follows its own formulation, so the CPU tests check the
arithmetic of each design. The wrappers take bf16 only, like the
prototypes, with C_in and C_out multiples of 64, and any B, H, W; they
check that contract on every device. Then a CUDA tensor goes to the kernel
(built at first use by `_build.py`; a build or launch failure raises) and a
CPU tensor to the plain version. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._build import uses_kernel

launches = {"stream_conv3x3": 0, "npack_conv3x3": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I] * 5 + [_P]
_CHANNELS = 64  # C_in and C_out are multiples of this
# both kernels' unit of work (csrc/conv3x3_tile.cuh): a strip of STRIP_ROWS
# output rows x STRIP_COLS pixels of one image and one group of 64 output
# channels, walked top to bottom through its input rows
STRIP_ROWS, STRIP_COLS = 64, 64
# shared memory per block (csrc/conv3x3_tile.cuh::make_plan): one input row
# of a stage (one box of STRIP_COLS + 2 pixels x 64 channels, 1024-byte
# aligned), the weights of one K atom (three dy boxes of 3 x 64 x 64), the
# staging tile of each consumer, the barriers and the alignment slack
_ROW_BYTES = 9 * 1024
_ATOM_W_BYTES = 9 * _CHANNELS * _CHANNELS * 2
_MAX_STAGES = 6
_FIXED_BYTES = 2 * STRIP_COLS * _CHANNELS * 2 + 8 * (4 * _MAX_STAGES + 1) + 1024


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def pack_row_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO w (3, 3, C_in, C_out) -> (3 C_in, 3 C_out): row dx * C_in + ci
    (the dx taps folded with the input channels), column dy * C_out + co
    (the dy taps side by side); the prototype's `wpack`."""
    ci, co = w.shape[2], w.shape[3]
    return torch.cat([w[dy].reshape(3 * ci, co) for dy in range(3)], dim=-1)


def stream_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The nine tap products of the zero-padded input, summed in f32 in
    tap order, rounded to x's dtype."""
    _, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            part = xp[:, dy:dy + H, dx:dx + W, :] @ wf[dy, dx]
            acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def npack_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P = cat @ pack_row_taps(w) in f32 over all H + 2 padded rows (cat:
    the three dx-shifted copies of the padded input side by side), then the
    row-shifted sum of P's three column blocks, rounded to x's dtype."""
    _, H, W, _ = x.shape
    co = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    cat = torch.cat([xp[:, :, dx:dx + W, :] for dx in range(3)], dim=-1)  # (B, H+2, W, 3 C_in)
    p = cat @ pack_row_taps(w.float())  # (B, H+2, W, 3 C_out)
    out = p[:, 0:H, :, 0:co] + p[:, 1:H + 1, :, co:2 * co] + p[:, 2:H + 2, :, 2 * co:]
    return out.to(x.dtype)


def shared_plan(ci: int) -> dict:
    """Shared memory of one block of either kernel for C_in = ci (bytes
    <= _build.MAX_SHARED_BYTES for every C_in): the weights of the block's
    output-channel group stay resident while they fit beside at least one
    stage per pipeline, else each stage carries its K atom's weights;
    `stages` per pipeline (two pipelines, at most 6 each)."""
    atoms = ci // _CHANNELS
    resident = atoms * _ATOM_W_BYTES + _FIXED_BYTES + 2 * _ROW_BYTES <= _build.MAX_SHARED_BYTES
    w_bytes = atoms * _ATOM_W_BYTES if resident else 0
    stage = _ROW_BYTES if resident else _ROW_BYTES + _ATOM_W_BYTES
    stages = min(_MAX_STAGES, (_build.MAX_SHARED_BYTES - _FIXED_BYTES - w_bytes) // (2 * stage))
    return {"resident": resident, "stages": stages, "stage_bytes": stage,
            "bytes": w_bytes + 2 * stages * stage + _FIXED_BYTES}


def input_rows(H: int) -> int:
    """Input rows one column strip loads over the image's height, halo rows
    of neighbouring strips included (rows outside the image are not
    loaded): the N-packed kernel computes P for each."""
    return sum(min(y0 + STRIP_ROWS, H - 1) - max(y0 - 1, 0) + 1
               for y0 in range(0, H, STRIP_ROWS))


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtypes {x.dtype} / {w.dtype} not supported (bfloat16 only)")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    ci = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"{name}: w {tuple(w.shape)} does not fit C_in {ci} (HWIO, 3 x 3)")
    co = w.shape[-1]
    if ci % _CHANNELS or co % _CHANNELS or ci == 0 or co == 0:
        raise ValueError(f"{name}: channels {ci} -> {co}: C_in and C_out must be positive "
                         f"multiples of {_CHANNELS}")
    if w.device != x.device:
        raise ValueError(f"{name}: x and w on different devices")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the TMA maps of the wgmma
    conv bodies, here and in the VGG block)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, H, W, ci = x.shape
    co = w.shape[-1]
    out = torch.empty(B, H, W, co, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, w = aligned16(x), aligned16(w)
    fn = _build.function(name, _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, ci, co,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    launches[name] += 1
    return out


def stream_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C_in) bf16, w (3, 3, C_in, C_out) bf16 -> (B, H, W,
    C_out) bf16. CUDA tensors run csrc/conv3x3_stream.cu; CPU tensors
    `stream_conv3x3_plain`."""
    _check("stream_conv3x3", x, w)
    if not uses_kernel(x.device):
        return stream_conv3x3_plain(x, w)
    return _launch("stream_conv3x3", x, w)


def npack_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C_in) bf16, w (3, 3, C_in, C_out) bf16 -> (B, H, W,
    C_out) bf16. CUDA tensors run csrc/conv3x3_npack.cu; CPU tensors
    `npack_conv3x3_plain`."""
    _check("npack_conv3x3", x, w)
    if not uses_kernel(x.device):
        return npack_conv3x3_plain(x, w)
    return _launch("npack_conv3x3", x, w)
