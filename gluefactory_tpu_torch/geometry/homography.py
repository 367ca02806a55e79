"""Homography sampling, estimation, warps and errors (counterpart of
`gluefactory_tpu/geometry/homography.py`).

Host side (numpy), for the data workers: `sample_homography_corners` draws
from the caller's numpy generator in the JAX package's call order, so the
same generator state gives the same matrices. Device side (torch, batched):
point warps and reprojection errors for GT generation and metrics.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------------


def flat2mat(H8):
    """(..., 8) -> (..., 3, 3) with H[2, 2] = 1."""
    H8 = np.asarray(H8)
    return np.concatenate([H8, np.ones_like(H8[..., :1])], axis=-1).reshape(H8.shape[:-1] + (3, 3))


def create_center_patch(shape, patch_shape=None):
    """Corners (left-bottom, left-top, right-top, right-bottom) of a
    `patch_shape` (w, h) patch centred in a frame of `shape` (w, h)."""
    if patch_shape is None:
        patch_shape = shape
    width, height = shape
    pwidth, pheight = patch_shape
    left = int((width - pwidth) / 2)
    bottom = int((height - pheight) / 2)
    right = int((width + pwidth) / 2)
    top = int((height + pheight) / 2)
    return np.array([[left, bottom], [left, top], [right, top], [right, bottom]])


def check_convex(patch, min_convexity=0.05) -> bool:
    """Is the polygon (N, 2) convex with clockwise winding: every incoming
    edge's z cross product with the outgoing one at most -min_convexity."""
    p = np.asarray(patch, dtype=np.float64)
    out_edge = np.roll(p, -1, axis=0) - p
    in_edge = np.roll(out_edge, 1, axis=0)
    cross = in_edge[:, 0] * out_edge[:, 1] - out_edge[:, 0] * in_edge[:, 1]
    return bool(np.all(cross <= -min_convexity))


def _rotate_about(points, center, angle):
    c, s = math.cos(angle), math.sin(angle)
    d = points - center
    return np.stack([d[:, 0] * c + d[:, 1] * s, d[:, 1] * c - d[:, 0] * s], 1) + center


def sample_homography_corners(shape, patch_shape, difficulty=1.0, translation=0.4, n_angles=10,
                              max_angle=90, min_convexity=0.05, rng=np.random):
    """A random homography mapping a convex quadrilateral of the source frame
    `shape` (w, h) onto the `patch_shape` patch:
      1. the frame corners perturbed inward up to the `difficulty`-shrunk
         centre patch, drawn again until convex;
      2. the quad re-centred on the shrunk patch's centroid;
      3. rotated about its centroid by the first of `n_angles - 1` shuffled
         candidates (range scaled by `difficulty`) that keeps it inside
         the frame, unrotated if none does;
      4. translated by a uniform in-bounds offset scaled by
         `translation * difficulty`.
    Returns (H, frame corners, warped frame corners, patch_shape); H maps
    source pixel coordinates to patch pixel coordinates."""
    width, height = shape
    norm = np.array(shape, dtype=np.float64)
    frame = create_center_patch(shape)
    target = create_center_patch(patch_shape)
    inner = create_center_patch(shape, (width * (1 - difficulty), height * (1 - difficulty)))
    spread = inner - frame

    quad = inner.astype(np.float64)
    while True:
        cand = frame + rng.uniform(0.0, 1.0, size=(4, 2)) * spread
        if check_convex(cand / norm, min_convexity):
            quad = cand
            break
    quad = quad + (inner.mean(0) - quad.mean(0))[None]

    if n_angles > 0 and difficulty > 0:
        limit = math.radians(max_angle) * difficulty
        angles = np.linspace(-limit, limit, n_angles)
        rng.shuffle(angles)
        rng.shuffle(angles)
        centroid = quad.mean(0, keepdims=True)
        for angle in angles[: n_angles - 1]:
            cand = _rotate_about(quad, centroid, angle)
            scaled = cand / norm
            if np.all((scaled >= 0.0) & (scaled < 1.0)):
                quad = cand
                break

    if translation > 0:
        lo = -quad.min(0)
        hi = norm - quad.max(0)
        quad = quad + rng.uniform(lo, hi)[None] * (translation * difficulty)

    H = compute_homography_np(quad, target, [1.0, 1.0])
    frame_h = np.concatenate([frame, np.ones((4, 1))], 1) @ H.astype(np.float64).T
    warped = frame_h[:, :2] / frame_h[:, 2:]
    return H, frame.astype(np.float64), warped, patch_shape


def compute_homography_np(pts1, pts2, shape=(1.0, 1.0)) -> np.ndarray:
    """DLT homography from >= 4 correspondences: points normalised by
    `shape`, the 2N x 9 system solved by SVD. float32 (3, 3), H[2, 2] = 1."""
    shape = np.asarray(shape, dtype=np.float64)
    pts1 = np.asarray(pts1, dtype=np.float64) / shape[None]
    pts2 = np.asarray(pts2, dtype=np.float64) / shape[None]
    n = pts1.shape[0]
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = pts1[i]
        u, v = pts2[i]
        A[2 * i] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
        A[2 * i + 1] = [x, y, 1, 0, 0, 0, -u * x, -u * y, -u]
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    S = np.diag([1.0 / shape[0], 1.0 / shape[1], 1.0])
    Sinv = np.diag([shape[0], shape[1], 1.0])
    H = Sinv @ H @ S
    return (H / H[2, 2]).astype(np.float32)


# ---------------------------------------------------------------------------
# device side (torch, batched)
# ---------------------------------------------------------------------------


def warp_points(points: torch.Tensor, H: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Warp (..., N, 2) points by homographies (..., 3, 3); `inverse` warps by
    H^-1. The homogeneous divide adds 1e-8 to the last coordinate."""
    H = torch.linalg.inv(H) if inverse else H
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    warped = torch.einsum("...ij,...nj->...ni", H, pts_h)
    return warped[..., :-1] / (warped[..., -1:] + 1e-8)


def sym_homography_error(kpts0, kpts1, T_0to1) -> torch.Tensor:
    """Symmetric reprojection error of aligned correspondences (..., N)."""
    dist0_1 = torch.linalg.vector_norm(warp_points(kpts0, T_0to1) - kpts1, dim=-1)
    dist1_0 = torch.linalg.vector_norm(warp_points(kpts1, T_0to1, inverse=True) - kpts0, dim=-1)
    return (dist0_1 + dist1_0) / 2.0


def sym_homography_error_all(kpts0, kpts1, H) -> torch.Tensor:
    """All-pairs symmetric error matrix (..., N0, N1)."""
    kpts0_1 = warp_points(kpts0, H)
    kpts1_0 = warp_points(kpts1, H, inverse=True)
    dist0 = torch.linalg.vector_norm(kpts0_1[..., :, None, :] - kpts1[..., None, :, :], dim=-1)
    dist1 = torch.linalg.vector_norm(kpts0[..., :, None, :] - kpts1_0[..., None, :, :], dim=-1)
    return (dist0 + dist1) / 2.0


def homography_corner_error(T, T_gt, image_size) -> torch.Tensor:
    """Mean distance between the four image corners warped by T and by T_gt;
    `image_size` (..., 2) is [w, h]."""
    image_size = torch.as_tensor(image_size, dtype=torch.float32, device=T.device)
    w, h = image_size[..., 0], image_size[..., 1]
    zeros = torch.zeros_like(w)
    corners = torch.stack([torch.stack([zeros, zeros], -1), torch.stack([w, zeros], -1),
                           torch.stack([w, h], -1), torch.stack([zeros, h], -1)], dim=-2)
    err = warp_points(corners, T) - warp_points(corners, T_gt)
    return torch.linalg.vector_norm(err, dim=-1).mean(dim=-1)
