"""Patches around keypoints and keypoint heatmaps (counterpart of
`gluefactory_tpu/utils/patches.py`), batched tensors of static shapes.

Pixel indices are round(kpts - 0.5), half to even as `torch.round` and
`jnp.round` round, clipped into the image; `extract_patches` also returns
which patches lie whole inside the image.
"""

from __future__ import annotations

import torch


def extract_patches(image: torch.Tensor, kpts: torch.Tensor, radius: int):
    """(2r+1)^2 patches around the keypoints' pixels: image (B, H, W, C),
    kpts (B, N, 2) -> (patches (B, N, 2r+1, 2r+1, C), valid (B, N))."""
    B, H, W, C = image.shape
    d = 2 * radius + 1
    centers = torch.round(kpts - 0.5).long()
    offs = torch.arange(-radius, radius + 1, device=image.device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    ys = centers[..., 1][..., None, None] + dy
    xs = centers[..., 0][..., None, None] + dx
    cx, cy = centers[..., 0], centers[..., 1]
    valid = (cx >= radius) & (cx < W - radius) & (cy >= radius) & (cy < H - radius)
    idx = (ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)).reshape(B, -1)
    patches = torch.gather(image.reshape(B, H * W, C), 1, idx[..., None].expand(-1, -1, C))
    return patches.reshape(B, kpts.shape[1], d, d, C), valid


def build_heatmap(shape, kpts: torch.Tensor, scores: torch.Tensor | None = None) -> torch.Tensor:
    """The keypoints' scores (ones if None) summed into a (B, H, W) map at
    their clipped pixels."""
    B, H, W = shape
    x = torch.round(kpts[..., 0] - 0.5).long().clamp(0, W - 1)
    y = torch.round(kpts[..., 1] - 0.5).long().clamp(0, H - 1)
    if scores is None:
        scores = torch.ones(kpts.shape[:2], dtype=torch.float32, device=kpts.device)
    flat = torch.zeros(B, H * W, dtype=scores.dtype, device=kpts.device)
    rows = torch.arange(B, device=kpts.device)[:, None].expand_as(x)
    flat.index_put_((rows, y * W + x), scores, accumulate=True)
    return flat.reshape(B, H, W)
