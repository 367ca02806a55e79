"""Depth sampling and two-view reprojection (counterpart of
`gluefactory_tpu/geometry/depth.py`): bilinear depth sampling that falls
back to the nearest pixel where an invalid depth takes part, and the chain
image -> camera -> transform -> camera -> image with validity and an
optional cycle-consistency check. Batched over (B, N) points, on the
inputs' device.
"""

from __future__ import annotations

import torch

from .utils import image_grid
from .wrappers import Camera, Pose


def _gather(depth: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
    """(value, poisoned) of the (B, H, W) map at integer (B, N) positions:
    0 outside the image; inside, the depth, or 0 and poisoned where it is
    invalid (<= 0 or not finite)."""
    B, H, W = depth.shape
    inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
    idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
    d = torch.gather(depth.reshape(B, H * W), 1, idx)
    poisoned = inb & ~(torch.isfinite(d) & (d > 0))
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.where(inb & ~poisoned, d, zero), poisoned


def _index(x: torch.Tensor) -> torch.Tensor:
    """An integral float as int64, NaN as 0 (as XLA converts it)."""
    return torch.nan_to_num(x, nan=0.0).to(torch.int64)


def sample_depth_bilinear(pts: torch.Tensor, depth: torch.Tensor):
    """Sample a (B, H, W) depth map at (B, N, 2) pixel points (COLMAP
    centres). An invalid pixel with a non-zero weight poisons the bilinear
    value, and the point takes the nearest pixel's depth instead; pixels
    outside the image count as 0. Returns (depth (B, N), valid (B, N))."""
    x = pts[..., 0] - 0.5
    y = pts[..., 1] - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    x0, y0 = _index(x0f), _index(y0f)
    d00, p00 = _gather(depth, y0, x0)
    d01, p01 = _gather(depth, y0, x0 + 1)
    d10, p10 = _gather(depth, y0 + 1, x0)
    d11, p11 = _gather(depth, y0 + 1, x0 + 1)
    bilin = (d00 * (1 - wx) * (1 - wy) + d01 * wx * (1 - wy)
             + d10 * (1 - wx) * wy + d11 * wx * wy)
    poisoned = ((p00 & ((1 - wx) * (1 - wy) > 0)) | (p01 & (wx * (1 - wy) > 0))
                | (p10 & ((1 - wx) * wy > 0)) | (p11 & (wx * wy > 0)))
    d_near, v_near = sample_depth_nearest(pts, depth)
    d = torch.where(poisoned, d_near, bilin)
    valid = torch.where(poisoned, v_near, bilin > 0)
    return torch.where(valid, d, torch.zeros_like(d)), valid


def sample_depth_nearest(pts: torch.Tensor, depth: torch.Tensor):
    """The depth of the nearest pixel (rounded half to even); valid inside
    the image where it is finite and positive."""
    B, H, W = depth.shape
    x = _index(torch.round(pts[..., 0] - 0.5)).clamp(0, W - 1)
    y = _index(torch.round(pts[..., 1] - 0.5)).clamp(0, H - 1)
    inb = (pts[..., 0] >= 0) & (pts[..., 0] < W) & (pts[..., 1] >= 0) & (pts[..., 1] < H)
    d = torch.gather(depth.reshape(B, H * W), 1, y * W + x)
    valid = inb & torch.isfinite(d) & (d > 0)
    return torch.where(valid, d, torch.zeros_like(d)), valid


def sample_depth(pts: torch.Tensor, depth: torch.Tensor, interpolation: str = "bilinear"):
    if interpolation == "nearest":
        return sample_depth_nearest(pts, depth)
    return sample_depth_bilinear(pts, depth)


def project(kpi, di, depthj, camera_i: Camera, camera_j: Camera, T_itoj: Pose, valid,
            ccth: float | None = None):
    """Project view i's keypoints (B, N, 2), with their sampled depths di,
    into view j. Returns (pixel coordinates (B, N, 2), validity (B, N)).
    With `ccth` the point must also come back: view j's depth there,
    lifted, moved back to view i and reprojected, lands within squared
    distance `ccth` of the keypoint."""
    kpi_3d_i = camera_i.image2cam(kpi) * di[..., None]
    kpi_j, visible = camera_j.cam2image(T_itoj.transform(kpi_3d_i))
    validj = valid & visible
    if ccth is None:
        return kpi_j, validj
    dj, valid_dj = sample_depth(kpi_j, depthj)
    kpi_j_3d_j = camera_j.image2cam(kpi_j) * dj[..., None]
    kpi_j_i, valid_cycle = camera_i.cam2image(T_itoj.inv().transform(kpi_j_3d_j))
    consistent = ((kpi - kpi_j_i) ** 2).sum(-1) < ccth
    return kpi_j, validj & valid_dj & valid_cycle & consistent


def dense_warp_consistency(depthi, depthj, T_itoj: Pose, camerai: Camera, cameraj: Camera,
                           **kwargs):
    """Every pixel of view i warped into view j by its depth. Returns
    (warped pixel grid (B, H, W, 2), valid (B, H, W))."""
    B, H, W = depthi.shape
    kpi = image_grid(H, W, device=depthi.device).reshape(1, H * W, 2).expand(B, H * W, 2)
    di = depthi.reshape(B, H * W)
    valid = torch.isfinite(di) & (di > 0)
    kpir, validr = project(kpi, di, depthj, camerai, cameraj, T_itoj, valid, **kwargs)
    return kpir.reshape(B, H, W, 2), validr.reshape(B, H, W)


def symmetric_reprojection_error(kpts0, kpts1, camera0: Camera, camera1: Camera, T_0to1: Pose,
                                 depth0, depth1):
    """Symmetric pixel reprojection error of aligned correspondences; valid
    where both depths are (projection bounds do not gate it). Returns
    (error (B, N), valid (B, N))."""
    d0, valid0 = sample_depth(kpts0, depth0)
    d1, valid1 = sample_depth(kpts1, depth1)
    kpts0_1, _ = project(kpts0, d0, depth1, camera0, camera1, T_0to1, valid0)
    kpts1_0, _ = project(kpts1, d1, depth0, camera1, camera0, T_0to1.inv(), valid1)
    err = 0.5 * (torch.linalg.vector_norm(kpts0_1 - kpts1, dim=-1)
                 + torch.linalg.vector_norm(kpts1_0 - kpts0, dim=-1))
    return err, valid0 & valid1
