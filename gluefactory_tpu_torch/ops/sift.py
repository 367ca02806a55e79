"""DoG SIFT on the device: detection, orientation and descriptor in torch
(counterpart of `gluefactory_tpu/ops/sift_jax.py`).

The whole scale-space pipeline (Gaussian pyramid, DoG extrema, one Newton
step of quadratic refinement, edge rejection, orientation histogram, 4x4x8
gradient descriptor) runs as torch ops on the images' device with static
shapes: a fixed candidate budget an octave and K output slots with a
validity mask. Constants are OpenCV's (sigma0 1.6, 3 scales an octave,
contrast threshold 0.04 applied as 0.5 * C / n_scales at the prefilter and
C / n_scales after interpolation, edge ratio 10), as in the JAX module.

Where torch and XLA differ, the port keeps XLA's semantics:
  - the refinement solves with LU (`solve_ex`, no error check and no host
    sync); a singular Hessian gives non-finite values that the |det| > 1e-12
    mask replaces by 0, as in JAX;
  - `_shift2` wraps around (`roll`); the 1-px border mask removes the
    wrapped sites;
  - patches are gathered by index from the zero-padded pyramid (no clamped
    `dynamic_slice`); the candidates' clip to [1, size - 2] keeps every
    window inside the padding;
  - `top_k` ties (the many zero responses of an octave with fewer extrema
    than its budget) may order differently: those slots are invalid, and
    `keypoint_mask` is `valid & (score > 0)` as in JAX;
  - the histograms are scatter-adds, whose order of addition is unspecified
    on CUDA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

RADIUS = 20  # static patch radius, sized for the largest in-octave sigma


def _gauss_kernel1d(sigma: float, device) -> torch.Tensor:
    r = max(1, int(round(4.0 * sigma)))
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, edge (replicate) padding. x: (B, H, W)."""
    if sigma <= 0:
        return x
    k = _gauss_kernel1d(sigma, x.device)
    r = (k.shape[0] - 1) // 2
    y = F.pad(x[:, None], (0, 0, r, r), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, -1, 1))
    y = F.pad(y, (r, r, 0, 0), mode="replicate")
    return F.conv2d(y, k.view(1, 1, 1, -1))[:, 0]


def build_octave(x: torch.Tensor, n_scales: int, sigma0: float):
    """Gaussian levels (B, n_scales + 3, H, W) and DoGs (B, n_scales + 2,
    H, W) of one octave whose base image already has blur sigma0."""
    k = 2.0 ** (1.0 / n_scales)
    levels = [x]
    sig_prev = sigma0
    for i in range(1, n_scales + 3):
        sig_total = sigma0 * (k**i)
        sig_diff = math.sqrt(max(sig_total**2 - sig_prev**2, 1e-8))
        levels.append(gaussian_blur(levels[-1], sig_diff))
        sig_prev = sig_total
    gauss = torch.stack(levels, dim=1)
    return gauss, gauss[:, 1:] - gauss[:, :-1]


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Spatial shift of (..., H, W) that wraps around."""
    return torch.roll(x, (dy, dx), dims=(-2, -1))


def find_extrema_mask(dogs: torch.Tensor, pre_thresh: float) -> torch.Tensor:
    """(B, S+2, H, W) -> (B, S, H, W) bool: 26-neighbour extrema of the
    middle S scales with |value| above the prefilter threshold, off the
    1-px border."""
    B, S2, H, W = dogs.shape
    c = dogs[:, 1:-1]
    is_max = torch.ones_like(c, dtype=torch.bool)
    is_min = torch.ones_like(c, dtype=torch.bool)
    for ds in (-1, 0, 1):
        nb_plane = dogs[:, 1 + ds:S2 - 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = _shift2(nb_plane, -dy, -dx)
                is_max &= c >= nb
                is_min &= c <= nb
    mask = (is_max | is_min) & (c.abs() > pre_thresh)
    ys = torch.arange(H, device=dogs.device)[:, None]
    xs = torch.arange(W, device=dogs.device)[None, :]
    return mask & ((ys >= 1) & (ys < H - 1) & (xs >= 1) & (xs < W - 1))


def _quad_refine(dogs, sidx, yidx, xidx):
    """One Newton step of the 3D quadratic fit at each candidate's integer
    extremum. dogs (B, S+2, H, W); indices (B, K). Returns offset (B, K, 3)
    in (x, y, s), the interpolated value (B, K) and edge_ok (B, K)."""
    b = torch.arange(dogs.shape[0], device=dogs.device)[:, None]

    def at(ds, dy, dx):
        return dogs[b, sidx + 1 + ds, yidx + dy, xidx + dx]

    v = at(0, 0, 0)
    dx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    dy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    ds = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
    dxx = at(0, 0, 1) + at(0, 0, -1) - 2 * v
    dyy = at(0, 1, 0) + at(0, -1, 0) - 2 * v
    dss = at(1, 0, 0) + at(-1, 0, 0) - 2 * v
    dxy = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
    dxs = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
    dys = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))

    H = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                     torch.stack([dxy, dyy, dys], -1),
                     torch.stack([dxs, dys, dss], -1)], -2)  # (B, K, 3, 3)
    g = torch.stack([dx, dy, ds], -1)
    det = (dxx * (dyy * dss - dys * dys) - dxy * (dxy * dss - dys * dxs)
           + dxs * (dxy * dys - dyy * dxs))
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    off = -torch.linalg.solve_ex(H + 1e-12 * eye, g[..., None], check_errors=False)[0][..., 0]
    off = torch.where(det.abs()[..., None] > 1e-12, off, torch.zeros_like(off))
    off = off.clamp(-1.5, 1.5)
    value = v + 0.5 * (g * off).sum(-1)

    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = 10.0
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
    return off, value, edge_ok


def _extract_patches(gauss, lvl, yc, xc, radius: int):
    """Integer-centred (2r+1)^2 patches from each candidate's own pyramid
    level, gathered from the zero-padded pyramid. gauss (B, S+3, H, W);
    lvl / yc / xc (B, K). Returns (B, K, d, d)."""
    d = 2 * radius + 1
    pad = F.pad(gauss, (radius, radius, radius, radius))
    steps = torch.arange(d, device=gauss.device)
    b = torch.arange(gauss.shape[0], device=gauss.device)[:, None, None, None]
    rows = (yc[..., None] + steps)[..., :, None]  # pad shifts centres by +radius
    cols = (xc[..., None] + steps)[..., None, :]
    return pad[b, lvl[..., None, None], rows, cols]


def _patch_grads(patch):
    """(..., d, d) -> gradient magnitude and angle maps (..., d-2, d-2)."""
    gx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    gy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    return torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)


def _orientation(mag, ang, sigma, radius: int):
    """Dominant gradient orientation of each candidate. mag / ang
    (K, d-2, d-2); sigma (K,). Returns theta (K,)."""
    di = torch.arange(-(radius - 1), radius, dtype=torch.float32, device=mag.device)
    d2 = di[None, :, None] ** 2 + di[None, None, :] ** 2
    sig_w = 1.5 * sigma
    w = torch.exp(-d2 / (2.0 * sig_w[:, None, None] ** 2))
    w = torch.where(d2 <= (3.0 * sig_w[:, None, None]) ** 2, w, torch.zeros_like(w))
    K = mag.shape[0]
    wm = (mag * w).reshape(K, -1)
    bins = torch.floor((ang + math.pi) / (2 * math.pi) * 36).to(torch.int64)
    bins = bins.clamp(0, 35).reshape(K, -1)
    hist = torch.zeros((K, 36), dtype=torch.float32, device=mag.device).scatter_add_(1, bins, wm)
    # cv2-style smoothing (two passes of [1, 4, 6, 4, 1] / 16)
    for _ in range(2):
        hist = (6 * hist + 4 * (torch.roll(hist, 1, -1) + torch.roll(hist, -1, -1))
                + (torch.roll(hist, 2, -1) + torch.roll(hist, -2, -1))) / 16.0
    b = torch.argmax(hist, dim=-1)
    hb = torch.gather(hist, 1, b[:, None])[:, 0]
    hl = torch.gather(hist, 1, ((b - 1) % 36)[:, None])[:, 0]
    hr = torch.gather(hist, 1, ((b + 1) % 36)[:, None])[:, 0]
    denom = hl - 2 * hb + hr
    frac = torch.where(denom.abs() > 1e-8, 0.5 * (hl - hr) / denom, torch.zeros_like(denom))
    return (b.to(torch.float32) + 0.5 + frac) * (2 * math.pi / 36) - math.pi


def _descriptor(mag, ang, sigma, theta, radius: int):
    """4x4x8 SIFT descriptor: rotated bilinear sampling of the patch
    gradient maps (K, d-2, d-2). Returns (K, 128), L2-normalised, clipped
    at 0.2 and normalised again."""
    K = mag.shape[0]
    d = 2 * radius + 1
    dev = mag.device
    hist_w = 3.0 * sigma  # cell width in px
    n_samp = 16  # samples an axis over the 4-cell window
    u = (torch.arange(n_samp, dtype=torch.float32, device=dev) + 0.5) / n_samp * 4.0 - 2.0
    vv, uu = torch.meshgrid(u, u, indexing="ij")  # uu varies along x
    cs, sn = torch.cos(theta), torch.sin(theta)
    px = (uu[None] * cs[:, None, None] - vv[None] * sn[:, None, None]) * hist_w[:, None, None]
    py = (uu[None] * sn[:, None, None] + vv[None] * cs[:, None, None]) * hist_w[:, None, None]
    c = radius - 1  # the gradient maps' centre
    sx = px + c
    sy = py + c
    x0 = torch.floor(sx).to(torch.int64).clamp(0, d - 4)
    y0 = torch.floor(sy).to(torch.int64).clamp(0, d - 4)
    fx = (sx - x0).clamp(0.0, 1.0)
    fy = (sy - y0).clamp(0.0, 1.0)
    inb = (sx >= 0) & (sx <= d - 3) & (sy >= 0) & (sy <= d - 3)

    def read(m, y, x):
        idx = (y * (d - 2) + x).reshape(K, -1)
        return torch.gather(m.reshape(K, -1), 1, idx).reshape(y.shape)

    msamp = (read(mag, y0, x0) * (1 - fx) * (1 - fy) + read(mag, y0, x0 + 1) * fx * (1 - fy)
             + read(mag, y0 + 1, x0) * (1 - fx) * fy + read(mag, y0 + 1, x0 + 1) * fx * fy)
    asamp = read(ang, torch.round(sy).to(torch.int64).clamp(0, d - 3),
                 torch.round(sx).to(torch.int64).clamp(0, d - 3))
    rel = torch.remainder(asamp - theta[:, None, None], 2 * math.pi)

    wgauss = torch.exp(-(uu**2 + vv**2)[None] / (2 * (4.0 / 2) ** 2))
    msamp = msamp * wgauss * inb

    # trilinear binning: cell (4x4) x orientation (8)
    cx = uu[None] + 2.0 - 0.5  # cell-space coordinates in [0, 4)
    cy = vv[None] + 2.0 - 0.5
    ob = rel / (2 * math.pi) * 8.0 - 0.5
    bx0, by0, bo0 = (torch.floor(t).to(torch.int64) for t in (cx, cy, ob))
    fxc, fyc, foc = cx - bx0, cy - by0, ob - bo0
    desc = torch.zeros((K, 128), dtype=torch.float32, device=dev)
    for dyc in (0, 1):
        for dxc in (0, 1):
            for doc in (0, 1):
                wy = 1 - fyc if dyc == 0 else fyc
                wx = 1 - fxc if dxc == 0 else fxc
                wo = 1 - foc if doc == 0 else foc
                yb = by0 + dyc
                xb = bx0 + dxc
                okc = (yb >= 0) & (yb < 4) & (xb >= 0) & (xb < 4)
                w = msamp * wy * wx * wo * okc
                flat_idx = (yb.clamp(0, 3) * 4 + xb.clamp(0, 3)) * 8 + torch.remainder(bo0 + doc, 8)
                desc.scatter_add_(1, flat_idx.expand(K, -1, -1).reshape(K, -1), w.reshape(K, -1))
    desc = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    desc = desc.clamp(max=0.2)
    return desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def sift_detect(images: torch.Tensor, max_kpts: int, *, n_octaves: int = 4, n_scales: int = 3,
                sigma0: float = 1.6, contrast_thresh: float = 0.04,
                double_image: bool = False) -> dict:
    """images (B, H, W) grey in [0, 1] -> static-shape SIFT outputs:
    keypoints (B, K, 2) in cv2's `kpt.pt` convention (pixel indices, no
    +0.5), keypoint_scores, scales (cv2's `size`, a diameter), oris (rad),
    descriptors (B, K, 128) and keypoint_mask."""
    B, H, W = images.shape
    K = max_kpts
    x = images.to(torch.float32)
    if double_image:
        x = F.interpolate(x[:, None], size=(2 * H, 2 * W), mode="bilinear", align_corners=False)[:, 0]
        first_sigma = math.sqrt(max(sigma0**2 - 4 * 0.5**2, 0.01))
        scale_mul = 0.5
    else:
        first_sigma = math.sqrt(max(sigma0**2 - 0.5**2, 0.01))
        scale_mul = 1.0
    x = gaussian_blur(x, first_sigma)

    pre_th = 0.5 * contrast_thresh / n_scales
    per_oct = max(K // 2, 256)
    cand = {k: [] for k in ("pos", "score", "scale", "ori", "desc", "valid")}
    for o in range(n_octaves):
        if x.shape[-2] < 16 or x.shape[-1] < 16:
            break
        gauss, dogs = build_octave(x, n_scales, sigma0)
        mask = find_extrema_mask(dogs, pre_th)
        _, S, h, w = mask.shape
        resp = torch.where(mask, dogs[:, 1:-1].abs(), torch.zeros((), device=x.device))
        vals, idx = torch.topk(resp.reshape(B, -1), per_oct, dim=1)
        sidx = idx // (h * w)
        yidx = ((idx % (h * w)) // w).clamp(1, h - 2)
        xidx = (idx % w).clamp(1, w - 2)

        off, value, edge_ok = _quad_refine(dogs, sidx, yidx, xidx)
        ok = (vals > 0) & (value.abs() > contrast_thresh / n_scales) & edge_ok
        ok &= off.abs().amax(-1) < 1.0
        sf = sidx.to(torch.float32) + off[..., 2]
        yf = yidx.to(torch.float32) + off[..., 1]
        xf = xidx.to(torch.float32) + off[..., 0]
        sig = sigma0 * (2.0 ** (sf / n_scales))  # octave-relative sigma
        lvl = (sidx + 1).clamp(0, n_scales + 2)
        patch = _extract_patches(gauss, lvl, yidx, xidx, RADIUS).flatten(0, 1)
        mag, ang = _patch_grads(patch)
        theta = _orientation(mag, ang, sig.flatten(), RADIUS)
        desc = _descriptor(mag, ang, sig.flatten(), theta, RADIUS)

        scale_px = (2.0**o) * scale_mul
        cand["pos"].append(torch.stack([xf * scale_px, yf * scale_px], dim=-1))
        cand["score"].append(value.abs())
        cand["scale"].append(sig * 2.0 * scale_px)
        cand["ori"].append(theta.view(B, per_oct))
        cand["desc"].append(desc.view(B, per_oct, 128))
        cand["valid"].append(ok)
        x = gauss[:, n_scales][:, ::2, ::2]  # the next octave's base

    cat = {k: torch.cat(v, dim=1) for k, v in cand.items()}
    score = torch.where(cat["valid"], cat["score"], torch.zeros((), device=x.device))
    vals, top = torch.topk(score, K, dim=1)

    def take(a):
        return torch.gather(a, 1, top.view(B, K, *([1] * (a.ndim - 2))).expand(B, K, *a.shape[2:]))

    return {
        "keypoints": take(cat["pos"]),
        "keypoint_scores": vals,
        "scales": take(cat["scale"]),
        "oris": take(cat["ori"]),
        "descriptors": take(cat["desc"]),
        "keypoint_mask": take(cat["valid"]) & (vals > 0),
    }
