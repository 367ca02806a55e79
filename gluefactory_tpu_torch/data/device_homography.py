"""Synthetic homography pairs made on the device (counterpart of
`gluefactory_tpu/data/device_homography.py`): with `train.device_augment`
the loader ships source images only (`data.emit_source`), and the corner
sampling, the DLT, the perspective warps and the photometric jitter run in
the train step on the batch's device.

The sampler has no data-dependent control flow: the host sampler's
rejection loops are fixed fans of candidates picked by masks, batched over
the items.
  1. perturb the frame's corners inward by uniform offsets bounded by the
     difficulty-shrunk centre patch; of 4 candidate draws the first convex
     one is kept (else a size-floored centre patch, never degenerate);
  2. re-centre the quad on the patch's centroid;
  3. rotate it about its centroid by the first of a shuffled fan of
     difficulty-scaled angles that keeps it inside the frame (unrotated if
     none does);
  4. translate it by a uniform in-bounds offset scaled by
     translation * difficulty.
The homography is the batched 4-point DLT (`geometry/homography.py`). Every
draw comes from a key of `utils/threefry.py`, so a key gives the JAX
package's homographies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.homography import compute_homography_dlt, create_center_patch
from ..ops.warp import _inverse, photometric_jitter, warp_perspective, warp_perspective_tiled
from ..utils import threefry

LAMBDAS = (1.0, 0.75, 0.5, 0.25, 0.0)  # the window-safe sampler's blends, largest first


def _convex_mask(quads: torch.Tensor, norm, min_convexity: float = 0.05) -> torch.Tensor:
    """(..., 4, 2) -> (...): every successive-edge cross product of the
    shape-normalised polygon <= -min_convexity (clockwise and convex)."""
    p = quads / norm
    out_e = torch.roll(p, -1, dims=-2) - p
    in_e = torch.roll(out_e, 1, dims=-2)
    cross = in_e[..., 0] * out_e[..., 1] - out_e[..., 0] * in_e[..., 1]
    return (cross <= -min_convexity).all(dim=-1)


def _patch(size, patch=None, device=None) -> torch.Tensor:
    return torch.as_tensor(create_center_patch(size, patch), dtype=torch.float32, device=device)


def sample_corner_quads(key, batch: int, source_size, difficulty: float = 0.5,
                        translation: float = 1.0, n_angles: int = 10, max_angle: float = 90.0,
                        min_convexity: float = 0.05, n_convex_tries: int = 4, device=None,
                        picks: dict | None = None):
    """(B, 4, 2) source quadrilaterals of the reference's distribution and
    the translated anchor rectangle (B, 4, 2), the window-safe sampler's
    lambda = 0 fallback (size-floored at 25% of the frame so it never
    degenerates as difficulty -> 1). `picks`, where given, receives each
    item's convex candidate (-1: none, the anchor) and rotation candidate
    (-1: unrotated)."""
    sw, sh = float(source_size[0]), float(source_size[1])
    size = (source_size[0], source_size[1])
    norm = torch.tensor([sw, sh], dtype=torch.float32, device=device)
    k_pert, k_ang, k_trans = threefry.split(key, 3)
    frame = _patch(size, device=device)
    inner = _patch(size, (sw * (1.0 - difficulty), sh * (1.0 - difficulty)), device)
    spread = inner - frame
    shrink = min(difficulty, 0.75)
    anchor = _patch(size, (sw * (1.0 - shrink), sh * (1.0 - shrink)), device)

    # stage 1: candidate perturbations, the first convex one
    u = threefry.uniform(k_pert, (n_convex_tries, batch, 4, 2), device, 0.0, 1.0)
    cands = frame + u * spread  # (K, B, 4, 2)
    ok = _convex_mask(cands, norm, min_convexity)  # (K, B)
    first = ok.int().argmax(dim=0)
    any_ok = ok.any(dim=0)
    picked = cands[first, torch.arange(batch, device=device)]
    quad = torch.where(any_ok[:, None, None], picked, anchor)
    if picks is not None:
        picks["convex"] = torch.where(any_ok, first, -1)

    # stage 2: re-centre onto the shrunk patch's centroid
    quad = quad + (inner.mean(0) - quad.mean(1))[:, None, :]

    # stage 3: the rotation fan, the first in-frame candidate
    if n_angles > 1 and difficulty > 0 and max_angle > 0:
        limit = math.radians(max_angle) * difficulty
        # jnp.linspace's float32 arithmetic: start (1 - i/div) + stop i/div
        step = np.arange(n_angles - 1, dtype=np.float32) / np.float32(n_angles - 1)
        lo_hi = np.float32(-limit), np.float32(limit)
        base = torch.from_numpy(np.append(lo_hi[0] * (1 - step) + lo_hi[1] * step, lo_hi[1]))
        keys = threefry.split(k_ang, batch).to(device)
        perm = threefry.permutation(keys, base.to(device))[:, :n_angles - 1]  # (B, A)
        centroid = quad.mean(1, keepdim=True)
        d = quad - centroid
        c, s = torch.cos(perm)[:, :, None], torch.sin(perm)[:, :, None]
        rx = d[:, None, :, 0] * c + d[:, None, :, 1] * s  # (B, A, 4)
        ry = d[:, None, :, 1] * c - d[:, None, :, 0] * s
        rot = torch.stack([rx, ry], dim=-1) + centroid[:, None]  # (B, A, 4, 2)
        scaled = rot / norm
        inside = ((scaled >= 0.0) & (scaled < 1.0)).all(dim=-1).all(dim=-1)  # (B, A)
        first_a = inside.int().argmax(dim=1)
        any_a = inside.any(dim=1)
        chosen = rot[torch.arange(batch, device=device), first_a]
        quad = torch.where(any_a[:, None, None], chosen, quad)
        if picks is not None:
            picks["rotation"] = torch.where(any_a, first_a, -1)
            picks["angle"] = torch.where(any_a, perm.gather(1, first_a[:, None])[:, 0], 0.0)

    # stage 4: in-bounds translation scaled by translation * difficulty
    lo = -quad.amin(dim=1)
    hi = norm - quad.amax(dim=1)
    t = threefry.uniform(k_trans, (batch, 2), device, 0.0, 1.0)
    shift = (lo + t * (hi - lo)) * (translation * difficulty)
    return quad + shift[:, None, :], anchor + shift[:, None, :]


def _patch_corners(batch: int, patch_size, device=None) -> torch.Tensor:
    """The patch's corners (B, 4, 2), in the source quads' vertex order."""
    return _patch((patch_size[0], patch_size[1]), device=device).expand(batch, 4, 2)


def sample_corner_homographies(key, batch: int, source_size, patch_size, difficulty: float = 0.5,
                               translation: float = 1.0, n_angles: int = 10,
                               max_angle: float = 90.0, device=None) -> torch.Tensor:
    """(B, 3, 3) homographies from source pixel coordinates to patch ones
    (the whole patch frame as the target, as the host sampler)."""
    quad, _ = sample_corner_quads(key, batch, source_size, difficulty, translation,
                                  n_angles=n_angles, max_angle=max_angle, device=device)
    return compute_homography_dlt(quad, _patch_corners(batch, patch_size, device))


def _max_tile_footprint(H: torch.Tensor, patch_size, tile=(16, 128)):
    """Each item's largest source footprint (h, w) over the output tiles:
    the bbox of a tile's four projected corners (a projective map keeps
    edges straight), (B,) each."""
    pw, ph = int(patch_size[0]), int(patch_size[1])
    th, tw = tile
    ny, nx = -(-ph // th), -(-pw // tw)
    dev = H.device
    xs = torch.arange(nx + 1, dtype=torch.float32, device=dev) * tw
    ys = torch.arange(ny + 1, dtype=torch.float32, device=dev) * th
    p = torch.stack([xs[None, :].expand(ny + 1, nx + 1).reshape(-1),
                     ys[:, None].expand(ny + 1, nx + 1).reshape(-1),
                     torch.ones((ny + 1) * (nx + 1), device=dev)])
    q = _inverse(H) @ p  # (B, 3, P)
    u = (q[:, 0] / (q[:, 2] + 1e-12)).reshape(-1, ny + 1, nx + 1)
    v = (q[:, 1] / (q[:, 2] + 1e-12)).reshape(-1, ny + 1, nx + 1)

    def extent(a):
        c = torch.stack([a[:, :-1, :-1], a[:, :-1, 1:], a[:, 1:, :-1], a[:, 1:, 1:]], dim=-1)
        return (c.amax(-1) - c.amin(-1)).flatten(1).amax(1)

    return extent(v), extent(u)


def _sample_window_safe_homography(key, batch: int, source_size, patch_size, difficulty,
                                   translation, window, tile=(16, 128), margin: float = 3.0,
                                   n_angles: int = 10, max_angle: float = 90.0, device=None,
                                   details: dict | None = None) -> torch.Tensor:
    """Homographies whose every output tile's source footprint fits the
    static `window` of `warp_perspective_tiled` less `margin`: each item's
    quad is blended toward its anchor rectangle (anchor + lambda (quad -
    anchor)) and the largest lambda of LAMBDAS whose footprint fits is
    kept; lambda = 0 always fits. `details`, where given, receives each
    item's lambda, the picks of `sample_corner_quads` and every blend's
    footprint (fh, fw) against the limits."""
    picks = {} if details is not None else None
    quad, anchor = sample_corner_quads(key, batch, source_size, difficulty, translation,
                                       n_angles=n_angles, max_angle=max_angle, device=device,
                                       picks=picks)
    corners = _patch_corners(batch, patch_size, device)
    wh, ww = float(window[0]), float(window[1])
    H_best = fits_prev = lam_best = None
    footprints = []
    for lam in LAMBDAS:
        Hl = compute_homography_dlt(anchor + lam * (quad - anchor), corners)
        fh, fw = _max_tile_footprint(Hl, patch_size, tile)
        footprints.append((fh, fw))
        fits = (fh <= wh - margin) & (fw <= ww - margin)
        if H_best is None:
            H_best, fits_prev = Hl, fits
            lam_best = torch.full((batch,), lam, device=Hl.device)
        else:
            take = fits & ~fits_prev
            H_best = torch.where(take[:, None, None], Hl, H_best)
            lam_best = torch.where(take, lam, lam_best)
            fits_prev = fits_prev | fits
    if details is not None:
        details.update(picks, **{"lambda": lam_best, "footprints": footprints,
                                 "limits": (wh - margin, ww - margin)})
    return H_best


def tiled_window(source_hw, patch_size) -> tuple[int, int]:
    """The static source window (h, w) of `warp_perspective_tiled` for
    sources of (h, w) and patches of (w, h): a (16, 128) output tile's
    footprint bounded by the patch-to-source scale plus rotation and
    perspective spread, no larger than the source rounded up."""
    sh, sw = source_hw
    sx = max(1.0, sw / float(patch_size[0]))
    sy = max(1.0, sh / float(patch_size[1]))
    return (min(int(np.ceil((16 * sy + 128 * sx * 0.6) / 8 + 1) * 8), int(np.ceil(sh / 8) * 8)),
            min(int(np.ceil((128 * sx + 16 * sy * 0.6) / 128 + 1) * 128),
                int(np.ceil(sw / 128) * 128)))


def generate_homography_pairs(source_images: torch.Tensor, key, patch_size=(640, 480),
                              difficulty: float = 0.5, translation: float = 1.0,
                              photometric_strength: float = 0.5, warp_impl: str = "tiled",
                              n_angles: int = 10, max_angle: float = 90.0,
                              details: dict | None = None, shard: tuple[int, int] = (0, 1)) -> dict:
    """source_images (B, H, W, C) -> a two-view batch with its exact
    `H_0to1`, on the images' device. `warp_impl`: "tiled" (the window-safe
    sampler and `warp_perspective_tiled`, the JAX package's default) or
    "gather" (`sample_corner_homographies` and `warp_perspective`).
    `details`, where given, receives the two views' sampler details (the
    tiled route's `_sample_window_safe_homography`, for the global batch)
    and the window. `shard` (rank, world): the images are rows rank * B ... of a global batch
    of world * B; every draw is made for the global batch and this shard's
    rows kept, so the views are the global batch's."""
    B = source_images.shape[0] * shard[1]
    rows = slice(shard[0] * source_images.shape[0], (shard[0] + 1) * source_images.shape[0])
    sh, sw = source_images.shape[1:3]
    dev = source_images.device
    k0, k1, kp0, kp1 = threefry.split(key, 4)
    if warp_impl == "tiled":
        win = tiled_window((sh, sw), patch_size)
        views = [{} if details is not None else None for _ in range(2)]
        H0, H1 = (_sample_window_safe_homography(k, B, (sw, sh), patch_size, difficulty,
                                                 translation, win, n_angles=n_angles,
                                                 max_angle=max_angle, device=dev, details=d)
                  for k, d in zip((k0, k1), views))
        if details is not None:
            details.update(view0=views[0], view1=views[1], window=win)

        def warp(im, H):
            return warp_perspective_tiled(im, H, patch_size, window=win)
    elif warp_impl == "gather":
        H0, H1 = (sample_corner_homographies(k, B, (sw, sh), patch_size, difficulty, translation,
                                             n_angles=n_angles, max_angle=max_angle, device=dev)
                  for k in (k0, k1))

        def warp(im, H):
            return warp_perspective(im, H, patch_size)
    else:
        raise ValueError(f"warp_impl {warp_impl!r}: 'tiled' or 'gather'")
    H0, H1 = H0[rows], H1[rows]
    img0, img1 = warp(source_images, H0), warp(source_images, H1)
    if photometric_strength > 0:
        img0 = photometric_jitter(img0, kp0, photometric_strength, shard)
        img1 = photometric_jitter(img1, kp1, photometric_strength, shard)
    size = torch.tensor([[float(patch_size[0]), float(patch_size[1])]],
                        device=dev).expand(source_images.shape[0], 2)
    return {
        "view0": {"image": img0.to(source_images.dtype), "image_size": size},
        "view1": {"image": img1.to(source_images.dtype), "image_size": size},
        "H_0to1": H1 @ _inverse(H0),
    }
