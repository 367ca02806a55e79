"""Keypoint detection ops: NMS, border removal, static top-k selection
(counterpart of `gluefactory_tpu/ops/nms.py`).

Keypoint selection always returns exactly k keypoints with a validity mask.
Ties among equal scores follow the JAX package: `lax.top_k` keeps the lower
index first, reproduced here by a stable descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max pool with kernel 2r+1, stride 1, -inf padding. x: (B, H, W)."""
    return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, radius: int, iters: int = 2) -> torch.Tensor:
    """Iterated NMS: keep local maxima in a (2r+1)^2 window, suppressing
    neighbours of kept maxima so near-equal neighbours can survive.
    scores (B, H, W) -> same shape with suppressed entries zeroed."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool_2d(scores, radius)
    for _ in range(iters):
        supp_mask = max_pool_2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool_2d(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def remove_borders(scores: torch.Tensor, border: int) -> torch.Tensor:
    """Zero out a border margin of width `border`."""
    if border <= 0:
        return scores
    out = torch.zeros_like(scores)
    out[:, border:-border, border:-border] = scores[:, border:-border, border:-border]
    return out


def mask_outside(scores: torch.Tensor, true_size: torch.Tensor, border: int) -> torch.Tensor:
    """Zero scores (B, H, W) at x >= w - border or y >= h - border, with
    true_size (B, 2) [w, h] the true image area of a padded buffer."""
    B, H, W = scores.shape
    ts = true_size.to(device=scores.device, dtype=torch.float32)
    xs = torch.arange(W, dtype=torch.float32, device=scores.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=scores.device)[None, :, None]
    in_area = (xs < ts[:, 0, None, None] - border) & (ys < ts[:, 1, None, None] - border)
    return torch.where(in_area, scores, torch.zeros_like(scores))


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last dim, equal values in index order (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_keypoints(scores: torch.Tensor, k: int, threshold: float = 0.0,
                    nms_radius: int | None = None):
    """Select the top-k scoring pixels as keypoints (static shape).

    scores (B, H, W) -> (keypoints (B, k, 2) xy with the COLMAP +0.5 offset,
    kp_scores (B, k), valid (B, k)). With `nms_radius` (scores already
    NMS'd with it), survivors are more than r apart, so a t x t tile with
    t <= r + 1 holds at most one: a per-tile max shrinks the sort by t^2.
    """
    B, H, W = scores.shape
    tile = 0
    if nms_radius is not None and nms_radius >= 1:
        tile = min(nms_radius + 1, 4)
        while tile > 1 and (H % tile or W % tile):
            tile -= 1
    Ht, Wt = (H // tile, W // tile) if tile >= 2 else (0, 0)
    if tile >= 2 and scores.dtype == torch.bfloat16:
        # bf16 branch: the score's bit pattern (order-preserving for the
        # non-negative NMS'd scores) above the tile-local position, packed in
        # int64 (torch has no full uint32). Equal scores inside a tile: the
        # higher local index wins.
        bits = scores.view(torch.int16).to(torch.int64) & 0xFFFF
        ly = torch.arange(H, device=scores.device) % tile
        lx = torch.arange(W, device=scores.device) % tile
        key = (bits << 16) | (ly[:, None] * tile + lx[None, :])[None]
        tile_key = key.reshape(B, Ht, tile, Wt, tile).amax(dim=(2, 4))
        topk, tidx = _top_k(tile_key.reshape(B, Ht * Wt), k)
        vals = (topk >> 16).to(torch.int16).view(torch.bfloat16)
        inner = topk & 0xFFFF
        threshold_t = torch.tensor(threshold, dtype=vals.dtype, device=vals.device)
        valid = vals > threshold_t
    elif tile >= 2:
        blocks = scores.reshape(B, Ht, tile, Wt, tile).permute(0, 1, 3, 2, 4)
        tile_max, tile_arg = blocks.reshape(B, Ht * Wt, tile * tile).max(dim=-1)
        vals, tidx = _top_k(tile_max, k)
        inner = tile_arg.gather(1, tidx)
        valid = vals > threshold
    else:
        vals, idx = _top_k(scores.reshape(B, H * W), k)
        xs = (idx % W).float()
        ys = (idx // W).float()
        kpts = torch.stack([xs, ys], dim=-1) + 0.5
        return kpts, vals, vals > threshold
    xs = (tidx % Wt * tile + inner % tile).float()
    ys = (tidx // Wt * tile + inner // tile).float()
    kpts = torch.stack([xs, ys], dim=-1) + 0.5
    return kpts, vals, valid


def soft_argmax_refinement(kpts: torch.Tensor, scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Sub-pixel refinement: the score-weighted mean position in a
    (2r+1)^2 window around each keypoint (reference `superpoint.py:97-113`).

    kpts (B, K, 2) xy with the +0.5 offset; scores (B, H, W), the dense
    score map. Window pixels outside the image weigh nothing (the gather
    index is clipped, the weight masked); the weights' sum gets +1e-8.
    """
    B, H, W = scores.shape
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=kpts.device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    offsets = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (d*d, 2)
    pos = (kpts - 0.5)[:, :, None, :] + offsets  # (B, K, d*d, 2), array indices
    xi = torch.round(pos[..., 0]).long().clamp(0, W - 1)
    yi = torch.round(pos[..., 1]).long().clamp(0, H - 1)
    inb = (pos[..., 0] >= 0) & (pos[..., 0] <= W - 1) & (pos[..., 1] >= 0) & (pos[..., 1] <= H - 1)
    s = scores.reshape(B, H * W).gather(1, (yi * W + xi).reshape(B, -1)).reshape(inb.shape) * inb
    wsum = s.sum(dim=-1, keepdim=True) + 1e-8
    return (pos * s[..., None]).sum(dim=-2) / wsum + 0.5
