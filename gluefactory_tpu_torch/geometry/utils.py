"""Low-level batched geometry helpers (counterpart of
`gluefactory_tpu/geometry/utils.py`). Every function takes tensors with any
batch dimensions and computes on their device.
"""

from __future__ import annotations

import torch


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last dim: (..., N) -> (..., N+1)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Divide by the last coordinate: (..., N+1) -> (..., N)."""
    return points[..., :-1] / (points[..., -1:] + eps)


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix of (..., 3) vectors -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        z, -v[..., 2], v[..., 1],
        v[..., 2], z, -v[..., 0],
        -v[..., 1], v[..., 0], z,
    ], dim=-1).reshape(v.shape[:-1] + (3, 3))


def so3exp_map(w: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rodrigues: so(3) vector (..., 3) -> rotation matrix (..., 3, 3);
    below `eps` the first-order map I + [w]x."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    small = theta < eps
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    w_hat = skew_symmetric(w / theta_safe)
    w_hat2 = w_hat @ w_hat
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(w_hat.shape)
    R = eye + s * w_hat + (1.0 - c) * w_hat2
    R0 = eye + skew_symmetric(w)
    return torch.where(small[..., None], R0, R)


def distort_points(pts: torch.Tensor, dist: torch.Tensor):
    """Radial distortion of normalized 2D points by every coefficient of
    `dist` (..., D) as a power of r^2, as the JAX package applies it.
    Returns (distorted points, valid mask)."""
    x2 = (pts * pts).sum(dim=-1, keepdim=True)
    radial = torch.zeros_like(x2[..., 0])
    rn = torch.ones_like(x2[..., 0])
    for i in range(dist.shape[-1]):
        rn = rn * x2[..., 0]
        radial = radial + dist[..., i] * rn
    out = pts * (1.0 + radial)[..., None]
    return out, torch.ones(out.shape[:-1], dtype=torch.bool, device=out.device)


def undistort_points(pts: torch.Tensor, dist: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Invert `distort_points` by `iters` fixed-point steps."""
    und = pts
    for _ in range(iters):
        dpts, _ = distort_points(und, dist)
        und = und + (pts - dpts)
    return und


def image_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-centre coordinates (h, w, 2) in COLMAP's convention: the top-left
    pixel's centre is (0.5, 0.5)."""
    x = torch.arange(w, dtype=dtype, device=device) + 0.5
    y = torch.arange(h, dtype=dtype, device=device) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)
