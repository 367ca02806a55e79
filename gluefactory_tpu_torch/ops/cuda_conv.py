"""SuperPoint's fused VGG-block kernel: the wrapper of the hand-written CUDA
kernel `csrc/vgg_block.cu` and its plain PyTorch version (counterpart of
`gluefactory_tpu/ops/pallas_conv.py`).

`fused_vgg_block` replaces `pallas_conv.py::fused_vgg_block`, with the same
public face: NHWC activations, HWIO weights, three variants (one conv +
pool, two convs + pool, two convs without pool). The TPU kernel's VMEM gates
(`fused_vgg_available`, `_row_limit`) are not carried over.

Dispatch is by device alone: a CUDA tensor goes to the kernel, which is
built at first use (`_build.py`) and raises if it does not build or launch;
a CPU tensor goes to `vgg_block_plain`. `launches` counts wrapper calls that
launched the kernel (one call runs both convs of a block).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._build import uses_kernel

launches = {"fused_vgg_block": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 9 + [_P]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def fused_vgg_block(x, wa, ba, wb=None, bb=None, pool: bool = True) -> torch.Tensor:
    """x (B,H,W,C_in) -> (B,H',W',C_out), H' = H // 2 when pooled. wa
    (3,3,C_in,C_mid), wb (3,3,C_mid,C_out) HWIO, biases (C,); weights and
    biases are cast to x's dtype. CUDA tensors run csrc/vgg_block.cu (f32 or
    bf16; C_in and C_mid multiples of 8, C_mid and C_out of 16); CPU tensors
    `vgg_block_plain`."""
    if not uses_kernel(x.device):
        return vgg_block_plain(x, wa, ba, wb, bb, pool)
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
    x = x.contiguous()
    # the kernel reads weights as (3, 3, C_out, C_in), C_in contiguous; an
    # HWIO view of weights already in that layout is passed without a copy
    wa, ba, *rest = (p.to(x.dtype).transpose(-1, -2).contiguous() if p.dim() == 4
                     else p.to(x.dtype).contiguous() for p in params)
    wb, bb = rest if two else (wa, ba)
    Ho, Wo = (H // 2, W // 2) if pool else (H, W)
    out = torch.empty(B, Ho, Wo, Co, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    mid = torch.empty(B, H, W, Cm, dtype=x.dtype, device=x.device) if two else out
    fn = _build.function("fused_vgg_block", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), wa.data_ptr(), ba.data_ptr(), wb.data_ptr(), bb.data_ptr(),
                mid.data_ptr(), out.data_ptr(), B, H, W, Ci, Cm, Co, int(two), int(pool),
                _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_vgg_block: kernel launch failed (cudaError {rc})")
    launches["fused_vgg_block"] += 1
    return out
