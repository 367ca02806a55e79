"""The body shared by the two conv-study tools (`profile_stream_conv`,
`profile_npack`): can a hand-written 3x3 conv at SuperPoint's conv1b shape
(8 x 1024^2 x 64, bf16, no bias, no ReLU) beat the library conv?

Inputs as the JAX prototypes make them: x ~ N(0, 0.5) and w ~ N(0, 0.05)
from `np.random.default_rng(0)`, cast to bf16 on the device. One JSON line
is printed, and printed again each time it grows:

- `lib_ms`: `F.conv2d` in channels-last bf16 with TF32 off (the prototypes'
  `xla_ms`);
- `maxdiff`: the kernel against that library conv, with `tol`: twice the
  gap bf16 rounding alone opens (the plain version in bf16 against the same
  in f32) plus one bf16 step at the largest output;
- `<kernel>_ms`, `plain_ms` (the kernel's plain PyTorch version);
- `bound_ms` and `bound_by`: the least time an H100 SXM could take for the
  function (input and output bytes once at 3.35 TB/s, or the multiply-adds
  at 989 TFLOP/s bf16, whichever is larger);
- `card`: the card's name and power limit.

Times come from CUDA events and exist only on a CUDA device; on the CPU
they are null (not measured). `kernel_calls` counts the wrapper calls the
run made, so a caller can hold the wrapper's launch count against it.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from .timing import WARMUP, card, cuda_time_ms

SHAPE = (8, 1024, 1024, 64)  # SuperPoint conv1b: B, H, W, C
REPS = 20
PEAK_BF16_OPS = 989e12  # H100 SXM, dense bf16 tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3


def bound(shape) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of x, w and out moved once
    and the conv's multiply-adds, on an H100 SXM."""
    B, H, W, C = shape
    n_bytes = 2 * (2 * B * H * W * C + 9 * C * C)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = 2.0 * B * H * W * 9 * C * C / PEAK_BF16_OPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def bf16_step(v: float) -> float:
    """The spacing of bf16 values at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(v, 2.0**-126))) - 7)


def make_inputs(shape, device: torch.device):
    """x (B, H, W, C) and w (3, 3, C, C) in bf16, drawn as the prototypes
    draw them (x one image at a time: the same numbers, less host memory)."""
    B, H, W, C = shape
    rng = np.random.default_rng(0)
    x = torch.empty(B, H, W, C, dtype=torch.bfloat16, device=device)
    for i in range(B):
        x[i] = torch.from_numpy(rng.normal(0, 0.5, (H, W, C)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.normal(0, 0.05, (3, 3, C, C)).astype(np.float32))
    return x, w.to(device, torch.bfloat16)


def run(key: str, kernel, plain, device="cuda", shape=SHAPE) -> dict:
    """Time and check `kernel` (a wrapper of `ops/cuda_conv3x3.py`) and its
    plain version `plain` against the library conv; print the growing JSON
    line; return its final contents."""
    dev = torch.device(device)
    timed = dev.type == "cuda"
    if timed:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' for a run without times")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    x, w = make_inputs(shape, dev)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        return F.conv2d(xc, wc, padding=1)

    out = {}

    def emit():
        print(json.dumps(out), flush=True)

    out["lib_ms"] = cuda_time_ms(library, REPS) if timed else None
    emit()
    ref = library().permute(0, 2, 3, 1)
    got = kernel(x, w)
    calls = 1
    out["maxdiff"] = float((got.float() - ref.float()).abs().max())
    del got, ref
    p32 = plain(x.float(), w.float())
    out["tol"] = (2.0 * float((p32.to(torch.bfloat16).float() - p32).abs().max())
                  + bf16_step(float(p32.abs().max())))
    del p32
    emit()
    if timed:
        out[key] = cuda_time_ms(lambda: kernel(x, w), REPS)
        calls += WARMUP + REPS
        out["plain_ms"] = cuda_time_ms(lambda: plain(x, w), 3, warmup=1)
    else:
        out[key] = out["plain_ms"] = None
    emit()
    out["bound_ms"], out["bound_by"] = bound(shape)
    out["card"] = card(dev)
    out["shape"] = list(shape)
    out["kernel_calls"] = calls
    emit()
    return out
