"""Attention primitives for the matchers: rotary position encoding and
masked multi-head attention (counterpart of `gluefactory_tpu/ops/attention.py`).

Rotary convention (that of the official LightGlue weights): channel pairs are
adjacent (2i, 2i+1); cos/sin are per pair, shape (..., N, D/2), applied as
(x_even * cos - x_odd * sin, x_even * sin + x_odd * cos).

`mha` and `bidirectional_attention` go to the wrappers of the hand-written
CUDA kernels (`cuda_attention.py`), which run the kernel for a CUDA tensor
and the plain version for a CPU tensor. `flash=False` asks for the plain
version on any device.
"""

from __future__ import annotations

import torch

from .cuda_attention import (
    attention_plain,
    bidirectional_plain,
    fused_attention,
    fused_bidirectional_attention,
)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairwise (-x2, x1) rotation on adjacent channel pairs."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., N, D); cos/sin (..., N, D/2). Computed in x's dtype: cos/sin
    come from f32 keypoints and would otherwise upcast a bf16 matcher."""
    cos2 = cos.repeat_interleave(2, dim=-1).to(x.dtype)
    sin2 = sin.repeat_interleave(2, dim=-1).to(x.dtype)
    return x * cos2 + rotate_half(x) * sin2


def mha(q, k, v, mask_q=None, mask_k=None, flash: bool = True):
    """Masked scaled-dot-product attention. q (B,H,M,D), k/v (B,H,N,D);
    masks (B,M) / (B,N) bool, True = valid. Returns (B,H,M,D); masked query
    rows and queries with no valid key return zeros."""
    if flash:
        return fused_attention(q, k, v, mask_k, mask_q)
    return attention_plain(q, k, v, mask_k, mask_q)


def bidirectional_attention(qk0, qk1, v0, v1, mask0=None, mask1=None, flash: bool = True):
    """Shared-QK cross-attention in both directions: qk0 (B,H,M,D), qk1
    (B,H,N,D). Returns (m0 (B,H,M,D), m1 (B,H,N,D))."""
    if flash:
        return fused_bidirectional_attention(qk0, qk1, v0, v1, mask0, mask1)
    return bidirectional_plain(qk0, qk1, v0, v1, mask0, mask1)
