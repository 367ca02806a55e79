"""Perspective warps and photometric jitter on the device (counterpart of
`gluefactory_tpu/ops/warp.py`): the on-device homography augmentation
(`data/device_homography.py`) warps the source images and jitters the
views inside the train step, so the loader only decodes images.

Images keep the JAX package's (B, H, W, C) layout. Homographies map source
pixel coordinates to target ones (cv2.warpPerspective's convention, pixel
centres at +0.5): an output pixel samples the source bilinearly at H^-1 of
its centre, zero outside.
"""

from __future__ import annotations

import torch

from ..utils import threefry
from .grid_sample import grid_sample_nd


def _inverse(H: torch.Tensor) -> torch.Tensor:
    """H^-1 of each (..., 3, 3) without the host read that checks for a
    singular matrix (a singular H gives a non-finite inverse, as in JAX)."""
    return torch.linalg.inv_ex(H).inverse


def _project(Hinv: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Points (x, y) (..., broadcast against the batch) mapped by Hinv
    (B, 3, 3): (u, v) each (B, *xs.shape), divided by w + 1e-12 as the JAX
    package divides."""
    shape = (-1,) + (1,) * xs.dim()
    h = [[Hinv[:, i, j].reshape(shape) for j in range(3)] for i in range(3)]
    q = [h[i][0] * xs + h[i][1] * ys + h[i][2] for i in range(3)]
    return q[0] / (q[2] + 1e-12), q[1] / (q[2] + 1e-12)


def warp_perspective(image: torch.Tensor, H: torch.Tensor, out_size) -> torch.Tensor:
    """Warp (B, Hin, Win, C) images by homographies H (B, 3, 3) into
    `out_size` = (width, height): the gather form."""
    B = image.shape[0]
    W, Hh = int(out_size[0]), int(out_size[1])
    dev = image.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    ys = torch.arange(Hh, dtype=torch.float32, device=dev)[:, None] + 0.5
    u, v = _project(_inverse(H.float()), xs, ys)
    pts = torch.stack([u, v], dim=-1).reshape(B, Hh * W, 2)
    return grid_sample_nd(image, pts).reshape(B, Hh, W, image.shape[-1])


def warp_perspective_tiled(image: torch.Tensor, H: torch.Tensor, out_size,
                           tile=(16, 128), window=(64, 256)) -> torch.Tensor:
    """`warp_perspective` with the JAX package's tiled contract: the JAX
    function (a TPU device: the MXU cannot gather) cuts the output into
    (th, tw) tiles and reads, for each, a static (sh, sw) source window
    placed at the floor of its footprint's bbox minus one pixel, clipped to
    the image padded up to the window; a bilinear tap outside the window
    reads zero, so a pixel equals the gather form's wherever its tile's
    footprint fits the window. Here each pixel is one bilinear gather with
    every tap outside its tile's window (or the image) zeroed, which is the
    same function; the taps are blended along x, then along y, as the JAX
    function's two hat-matrix products blend them.
    `device_homography._sample_window_safe_homography` keeps every
    footprint inside the window."""
    B, Hin, Win, C = image.shape
    W, Hh = int(out_size[0]), int(out_size[1])
    th, tw = tile
    sh, sw = window
    ny, nx = -(-Hh // th), -(-W // tw)
    Hs, Ws = max(Hin, sh), max(Win, sw)  # the image padded up to the window
    dev = image.device
    Hinv = _inverse(H.float())

    # each tile's window origin, from its corners' footprint
    cx = (torch.arange(nx, device=dev, dtype=torch.float32) * tw)[None, :, None] + \
        torch.tensor([0.0, tw, 0.0, tw], device=dev)
    cy = (torch.arange(ny, device=dev, dtype=torch.float32) * th)[:, None, None] + \
        torch.tensor([0.0, 0.0, th, th], device=dev)
    cu, cv = _project(Hinv, cx.expand(ny, nx, 4), cy.expand(ny, nx, 4))
    u0 = torch.floor(cu.amin(-1) - 0.5 - 1.0).clamp(0, Ws - sw)  # (B, ny, nx), array coords
    v0 = torch.floor(cv.amin(-1) - 0.5 - 1.0).clamp(0, Hs - sh)
    u0 = u0.repeat_interleave(tw, dim=2).repeat_interleave(th, dim=1)[:, :Hh, :W]
    v0 = v0.repeat_interleave(tw, dim=2).repeat_interleave(th, dim=1)[:, :Hh, :W]

    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    ys = torch.arange(Hh, dtype=torch.float32, device=dev)[:, None] + 0.5
    u, v = _project(Hinv, xs, ys)
    u, v = u - 0.5, v - 0.5  # array coordinates
    x0f, y0f = torch.floor(u), torch.floor(v)
    fx, fy = (u - x0f)[..., None], (v - y0f)[..., None]
    bidx = torch.arange(B, device=dev)[:, None, None]

    def tap(yf, xf):
        ok = ((xf >= u0) & (xf < u0 + sw) & (xf >= 0) & (xf < Win)
              & (yf >= v0) & (yf < v0 + sh) & (yf >= 0) & (yf < Hin))
        vals = image[bidx, yf.clamp(0, Hin - 1).long(), xf.clamp(0, Win - 1).long()]
        return vals.float() * ok[..., None]

    top = tap(y0f, x0f) * (1 - fx) + tap(y0f, x0f + 1) * fx
    bottom = tap(y0f + 1, x0f) * (1 - fx) + tap(y0f + 1, x0f + 1) * fx
    return (top * (1 - fy) + bottom * fy).to(image.dtype)


def photometric_jitter(image: torch.Tensor, key, strength: float = 0.5,
                       shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Brightness, contrast, gamma and Gaussian noise of each (B, H, W, C)
    image, drawn from `key` (`utils/threefry.py`) as the JAX package draws
    them. `shard` (rank, world): the images are rows rank * B ... of a
    global batch of world * B, whose draws are made and sliced."""
    k1, k2, k3, k4 = threefry.split(key, 4)
    B, dev = image.shape[0], image.device
    rank, world = shard
    rows = slice(rank * B, (rank + 1) * B)
    G = B * world
    brightness = 1.0 + strength * threefry.uniform(k1, (G, 1, 1, 1), dev, -0.3, 0.3)[rows]
    contrast = 1.0 + strength * threefry.uniform(k2, (G, 1, 1, 1), dev, -0.3, 0.3)[rows]
    gamma = 1.0 + strength * threefry.uniform(k3, (G, 1, 1, 1), dev, -0.4, 0.6)[rows]
    mean = image.mean(dim=(1, 2, 3), keepdim=True)
    out = (image - mean) * contrast + mean * brightness
    out = out.clamp(0.0, 1.0) ** gamma
    noise = strength * 0.02 * threefry.normal(k4, (G, *image.shape[1:]), dev)[rows]
    return (out + noise).clamp(0.0, 1.0)
