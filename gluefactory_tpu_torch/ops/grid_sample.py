"""Bilinear sampling of dense feature maps at keypoint locations
(counterpart of `gluefactory_tpu/ops/grid_sample.py`).

Maps keep the JAX package's (B, H, W, C) layout at these functions; a
channels-first map passes in as a permuted view, and the gather reads only
the sampled rows, so nothing is copied.
"""

from __future__ import annotations

import torch


def grid_sample_nd(fmap: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample fmap (B, H, W, C) at continuous pixel points (B, N, 2) [x, y]
    in the map's own pixel scale, COLMAP convention (pixel centers at +0.5).
    Zero padding outside. Returns (B, N, C) in the map's dtype; the blend
    runs in f32 (its weights come from f32 coordinates)."""
    B, H, W, C = fmap.shape
    x = points[..., 0] - 0.5
    y = points[..., 1] - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = (x - x0f)[..., None]
    wy = (y - y0f)[..., None]
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    bidx = torch.arange(B, device=fmap.device)[:, None]

    def gather(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        vals = fmap[bidx, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return vals * inb[..., None]

    out = (
        gather(y0, x0) * (1 - wx) * (1 - wy)
        + gather(y0, x0 + 1) * wx * (1 - wy)
        + gather(y0 + 1, x0) * (1 - wx) * wy
        + gather(y0 + 1, x0 + 1) * wx * wy
    )
    return out.to(fmap.dtype)


def sample_descriptors(kpts: torch.Tensor, desc_map: torch.Tensor, stride: int,
                       normalize: bool = True, legacy_offset: bool = True) -> torch.Tensor:
    """Sample a dense descriptor map (B, Hc, Wc, C) at full-resolution
    keypoints (B, N, 2): divide by `stride`, bilinear sample, L2-normalise.

    `legacy_offset` reproduces glue-factory's `sample_descriptors_fix_sampling`:
    a keypoint u samples map index (u - 0.5)/s - 0.5. The norm is taken in
    f32 and the result returned in the map's dtype."""
    pts = (kpts - 0.5) / float(stride) if legacy_offset else kpts / float(stride)
    desc = grid_sample_nd(desc_map, pts)
    if normalize:
        norm = torch.linalg.vector_norm(desc.float(), dim=-1, keepdim=True)
        desc = desc / (norm + 1e-8).to(desc.dtype)
    return desc.to(desc_map.dtype)
