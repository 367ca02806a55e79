"""SuperPoint's fused VGG-block kernel: the wrapper of the hand-written CUDA
kernel `csrc/vgg_block.cu` and its plain PyTorch version (counterpart of
`gluefactory_tpu/ops/pallas_conv.py`).

`fused_vgg_block` replaces `pallas_conv.py::fused_vgg_block`, with the same
public face: NHWC activations, HWIO weights, three variants (one conv +
pool, two convs + pool, two convs without pool). The TPU kernel's VMEM gates
(`fused_vgg_available`, `_row_limit`) are not carried over:
`vgg_kernel_available` states what the CUDA kernel takes.

In bf16 with C_in and C_out multiples of 64 a conv runs the wgmma body, in
strips of `strip_rows` output rows; every other shape, and f32, runs the
CUDA-core body (`conv_plan` says which).

Dispatch is by device alone: a CUDA tensor goes to the kernel, which is
built at first use (`_build.py`) and raises if it does not build or launch;
a CPU tensor goes to `vgg_block_plain`. With autograd recording and an
input that requires a gradient, the kernel's output carries the plain
version's gradient (`_autograd.py`, as the JAX package's `_vgg_ad_bwd`).
`launches` counts wrapper calls that launched the kernel (one call runs
both convs of a block).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._autograd import kernel_with_plain_grad, needs_grad
from ._build import uses_kernel
from .cuda_conv3x3 import aligned16

launches = {"fused_vgg_block": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 11 + [_P]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the wgmma body (csrc/conv3x3_tile.cuh): channels in K atoms and output
# groups of 64, units of a strip of S output rows x 64 pixels, two units of
# work in flight a block (one per consumer warpgroup)
WGMMA_CHANNELS = 64
STRIP_COLS = 64
STRIP_CHOICES = (128, 64, 32, 16, 8)


def reset_launches() -> None:
    launches["fused_vgg_block"] = 0


def vgg_block_plain(x, wa, ba, wb=None, bb=None, pool: bool = True) -> torch.Tensor:
    """relu(conv3x3(x, wa) + ba) [-> relu(conv3x3(., wb) + bb)] [-> maxpool
    2x2/2], NHWC in and out, HWIO weights, SAME zero padding, with the
    kernel's arithmetic: f32 sums and bias, the activation between the convs
    rounded to x's dtype, the output rounded to x's dtype. (`vgg_block_xla`
    of the JAX package adds the bias in x's dtype; in f32 the two agree.)"""

    def conv(v, w, b):  # v NCHW in x's dtype -> f32
        return torch.relu(F.conv2d(v.float(), w.float().permute(3, 2, 0, 1), b.float(), padding=1))

    y = conv(x.permute(0, 3, 1, 2), wa, ba)
    if wb is not None:
        y = conv(y.to(x.dtype), wb, bb)
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def vgg_kernel_available(H: int, W: int, c_in: int, c_mid: int, c_out: int, pool: bool) -> bool:
    """Whether the CUDA kernel takes a block of this shape: C_in a multiple
    of 8, C_mid and C_out of 16, and (as the JAX package's
    `fused_vgg_available` asks) an even H and W when it pools. The wrapper
    itself also takes odd sizes (the pool floors); SuperPoint routes every
    other block to its plain path."""
    return (H > 0 and W > 0 and c_in > 0 and c_in % 8 == 0 and c_mid > 0 and c_mid % 16 == 0
            and c_out > 0 and c_out % 16 == 0 and (not pool or (H % 2 == 0 and W % 2 == 0)))


def strip_rows(B: int, H: int, W: int, c_out: int, sm_count: int) -> int:
    """Output rows per unit of the wgmma body for a conv over (B, H, W) to
    c_out channels on `sm_count` SMs: of STRIP_CHOICES (all even, so a
    pooled pair never straddles two units), the one whose busiest consumer
    computes the fewest input rows (S + 2 for a strip of S rows; units
    spread over the kernel's persistent blocks, two consumers each, as in
    `conv3x3_tile.cuh::launch`); on a tie the taller strip."""
    groups = c_out // WGMMA_CHANNELS
    ncols = -(-W // STRIP_COLS)
    best = None
    for s in STRIP_CHOICES:
        units = B * -(-H // s) * ncols
        blocks = max(1, min(sm_count // max(groups, 1), -(-units // 2)))
        rows = -(-units // (2 * blocks)) * (min(s, H) + 2)
        if best is None or rows < best[0]:
            best = (rows, s)
    return best[1]


def conv_plan(B: int, H: int, W: int, c_in: int, c_mid: int, c_out: int | None, pool: bool,
              dtype: torch.dtype, sm_count: int) -> list[dict]:
    """For each conv of the block (conv_a, then conv_b when c_out is not
    None): the body that runs it ("wgmma" or "cuda_cores") and, for wgmma,
    its strip height."""
    convs = [(c_in, c_mid, pool and c_out is None)]
    if c_out is not None:
        convs.append((c_mid, c_out, pool))
    plan = []
    for ci, co, pooled in convs:
        wgmma = dtype == torch.bfloat16 and ci % WGMMA_CHANNELS == 0 and co % WGMMA_CHANNELS == 0
        plan.append({"c_in": ci, "c_out": co, "pool": pooled,
                     "body": "wgmma" if wgmma else "cuda_cores",
                     "strip": strip_rows(B, H, W, co, sm_count) if wgmma else 0})
    return plan


def _vgg_kernel(x, wa, ba, wb, bb, pool):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_vgg_block: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4:
        raise ValueError(f"fused_vgg_block: x must be NHWC, got {tuple(x.shape)}")
    B, H, W, Ci = x.shape
    two = wb is not None
    Cm = wa.shape[-1]
    Co = wb.shape[-1] if two else Cm
    if tuple(wa.shape) != (3, 3, Ci, Cm) or tuple(ba.shape) != (Cm,):
        raise ValueError(f"fused_vgg_block: wa {tuple(wa.shape)} / ba {tuple(ba.shape)} do not fit C_in {Ci}")
    if two and (tuple(wb.shape) != (3, 3, Cm, Co) or bb is None or tuple(bb.shape) != (Co,)):
        raise ValueError(f"fused_vgg_block: wb {tuple(wb.shape)} does not fit C_mid {Cm}")
    if Ci % 8 or Cm % 16 or Co % 16:
        raise ValueError(f"fused_vgg_block: channels {Ci} -> {Cm} -> {Co}: C_in must be a "
                         "multiple of 8, C_mid and C_out of 16")
    params = [wa, ba] + ([wb, bb] if two else [])
    if any(p.device != x.device for p in params):
        raise ValueError("fused_vgg_block: inputs on different devices")
    x = aligned16(x)
    # HWIO weights and biases in x's dtype; HWIO weights already so (as
    # SuperPoint keeps them) are passed without a copy
    wa, ba, *rest = (aligned16(p.to(x.dtype)) for p in params)
    wb, bb = rest if two else (wa, ba)
    Ho, Wo = (H // 2, W // 2) if pool else (H, W)
    out = torch.empty(B, Ho, Wo, Co, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    mid = torch.empty(B, H, W, Cm, dtype=x.dtype, device=x.device) if two else out
    fn = _build.function("fused_vgg_block", _ARGTYPES)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = conv_plan(B, H, W, Ci, Cm, Co if two else None, pool, x.dtype, sms)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                mid.data_ptr(), out.data_ptr(), B, H, W, Ci, Cm, Co, int(two), int(pool),
                _DTYPE_CODES[x.dtype], plan[0]["strip"], plan[-1]["strip"],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_vgg_block: kernel launch failed (cudaError {rc})")
    launches["fused_vgg_block"] += 1
    return out


def fused_vgg_block(x, wa, ba, wb=None, bb=None, pool: bool = True) -> torch.Tensor:
    """x (B,H,W,C_in) -> (B,H',W',C_out), H' = H // 2 when pooled. wa
    (3,3,C_in,C_mid), wb (3,3,C_mid,C_out) HWIO, biases (C,); weights and
    biases are cast to x's dtype. CUDA tensors run csrc/vgg_block.cu (f32 or
    bf16; C_in and C_mid multiples of 8, C_mid and C_out of 16); CPU tensors
    `vgg_block_plain`."""
    if not uses_kernel(x.device):
        return vgg_block_plain(x, wa, ba, wb, bb, pool)
    if needs_grad(x, wa, ba, wb, bb):
        return kernel_with_plain_grad(_vgg_kernel, vgg_block_plain, x, wa, ba, wb, bb, pool)
    return _vgg_kernel(x, wa, ba, wb, bb, pool)
