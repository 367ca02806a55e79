"""Space-to-depth execution of SuperPoint's first VGG block (counterpart of
`gluefactory_tpu/ops/s2d_conv.py`): conv1a + ReLU, conv1b + ReLU and the
2x2 pool computed at half resolution, with no depth-to-space.

  - the input is space-to-depth'd once: (B, H, W, C) -> (B, H/2, W/2, 4C),
    phase-major channels [q = (0,0), (0,1), (1,0), (1,1)];
  - a full-resolution SAME 3x3 conv restricted to the outputs of phase
    (py, px) is a 2x2 conv over the phase tensor with the phase's
    asymmetric padding (`phase_conv`);
  - the pool is the elementwise max of the four phase outputs.

Arithmetic is exact (the same taps, the same adds) up to float
reassociation. Plain PyTorch: the JAX package computes it with XLA convs
outside any Pallas kernel, and here `F.conv2d` (cuDNN on the card) takes
their place, as in the plain SuperPoint. Layouts are the JAX package's:
NHWC activations, HWIO kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), phase-major [(0,0),(0,1),(1,0),(1,1)]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def _phase_kernel(w3: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """A full-resolution 3x3 kernel (3, 3, Cin, Cout) scattered into the
    equivalent 2x2 phase-tensor kernel (2, 2, 4 Cin, Cout) of output phase
    (py, px). With row padding (1 - py, py), phase-kernel row u is the
    phase tensor's row offset u - (1 - py), and the tap of input phase qy
    lands at full-resolution dy = 2 (u - (1 - py)) + qy - py; only dy in
    {-1, 0, 1} carries weight (the same for columns)."""
    cin, cout = w3.shape[2], w3.shape[3]
    w = w3.new_zeros(2, 2, 4 * cin, cout)
    for u in range(2):
        for qy in range(2):
            dy = 2 * (u - (1 - py)) + qy - py
            if not -1 <= dy <= 1:
                continue
            for v in range(2):
                for qx in range(2):
                    dx = 2 * (v - (1 - px)) + qx - px
                    if not -1 <= dx <= 1:
                        continue
                    q = qy * 2 + qx
                    w[u, v, q * cin:(q + 1) * cin] = w3[dy + 1, dx + 1]
    return w


def phase_conv(s2d: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor | None, py: int,
               px: int) -> torch.Tensor:
    """The outputs of phase (py, px) of a full-resolution SAME 3x3 conv,
    computed on the phase tensor: (B, H2, W2, 4 Cin) -> (B, H2, W2, Cout)."""
    wq = _phase_kernel(w3, py, px).permute(3, 2, 0, 1)  # OIHW
    x = F.pad(s2d.permute(0, 3, 1, 2), (1 - px, px, 1 - py, py))
    return F.conv2d(x, wq, bias).permute(0, 2, 3, 1)


def vgg_block1_s2d(x: torch.Tensor, wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor,
                   bb: torch.Tensor) -> torch.Tensor:
    """pool2x2(relu(conv3x3_b(relu(conv3x3_a(x))))) at half resolution. x
    (B, H, W, C0) with H and W even; wa (3, 3, C0, C), wb (3, 3, C, C).
    Returns (B, H/2, W/2, C), the plain block's output."""
    s0 = space_to_depth(x)
    phases = [(py, px) for py in range(2) for px in range(2)]
    s1 = torch.cat([torch.relu(phase_conv(s0, wa, ba, py, px)) for py, px in phases], dim=-1)
    out = None
    for py, px in phases:
        o = torch.relu(phase_conv(s1, wb, bb, py, px))
        out = o if out is None else torch.maximum(out, o)
    return out
