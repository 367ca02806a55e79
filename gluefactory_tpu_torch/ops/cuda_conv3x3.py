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
# the N-packed kernel's tile: NPACK_ROWS output rows (the TPU kernel's ROWS)
# of a NPACK_STRIP-pixel column strip, P over NPACK_ROWS + 2 rows
NPACK_ROWS, NPACK_STRIP = 4, 16


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


def npack_shared_bytes(ci: int) -> int:
    """Shared memory of one block of the N-packed kernel: two patch buffers
    ((ROWS + 2) x (STRIP + 2) pixels, C_in + 8 bf16 each), the packed
    weights (3 C_in rows of 192 + 8 bf16) and the f32 scratch P ((ROWS + 2)
    x STRIP pixels of 192 + 8 floats)."""
    patch = (NPACK_ROWS + 2) * (NPACK_STRIP + 2) * (ci + 8) * 2
    wpack = 3 * ci * (3 * _CHANNELS + 8) * 2
    scratch = (NPACK_ROWS + 2) * NPACK_STRIP * (3 * _CHANNELS + 8) * 4
    return 2 * patch + wpack + scratch


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels' cp.async)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, H, W, ci = x.shape
    co = w.shape[-1]
    out = torch.empty(B, H, W, co, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, w = _aligned(x), _aligned(w)
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
    C_out) bf16. A block holds the whole packed K = 3 C_in in shared memory,
    so C_in is bounded by `npack_shared_bytes` (64 fits, 128 does not).
    CUDA tensors run csrc/conv3x3_npack.cu; CPU tensors
    `npack_conv3x3_plain`."""
    _check("npack_conv3x3", x, w)
    need = npack_shared_bytes(x.shape[-1])
    if need > _build.MAX_SHARED_BYTES:
        raise ValueError(f"npack_conv3x3: C_in {x.shape[-1]} needs {need} bytes of shared memory "
                         f"per block, over the {_build.MAX_SHARED_BYTES} a block may have")
    if not uses_kernel(x.device):
        return npack_conv3x3_plain(x, w)
    return _launch("npack_conv3x3", x, w)
