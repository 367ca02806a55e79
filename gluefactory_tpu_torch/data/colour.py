"""OpenCV's 8-bit colour conversions and CLAHE in numpy arithmetic, so that
the photometric augmentations need no cv2. Each repeats the arithmetic of
OpenCV 5's `cvtColor` / `createCLAHE` for uint8 RGB images:

- `rgb_to_hsv` (`COLOR_RGB2HSV`, hue in [0, 180)): the integer path with
  its division tables, `(255 << 12) / v` and `(180 << 12) / (6 diff)`
  rounded to the nearest;
- `hsv_to_rgb` (`COLOR_HSV2RGB`): float32 arithmetic with fused
  multiply-adds and truncation to uint8 in OpenCV's vector loop
  (`SIMD_PIXELS` = 32 pixels a step where the CPU dispatch is AVX2, as on
  the machines the JAX package runs), rounding in its scalar loop over the
  rest of each row;
- `rgb_to_lab` (`COLOR_RGB2LAB`, sRGB, D65): the bit-exact fixed-point
  path, its gamma table at 2^3 and cube-root table at 2^15 fractions;
- `lab_to_rgb` (`COLOR_LAB2RGB`): the bit-exact integer path (`Lab2RGBinteger`),
  L and a / b through tables at 2^14, the inverse gamma table of 4096 entries;
- `clahe` (`createCLAHE(clip, (8, 8)).apply`): tile histograms with the
  clip limit scaled by tile area over 256 and the excess redistributed,
  float32 bilinear interpolation between the tile LUTs.

Held bit-equal to cv2 over every colour (the conversions) and on random
images (CLAHE) by `tests/test_torch_augmentations.py`.
"""

from __future__ import annotations

import functools

import numpy as np

F32 = np.float32


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _by_rows(fn):
    """`fn` of a per-pixel conversion run over blocks of 32 rows, whose
    temporaries stay in cache (rows stay whole: `hsv_to_rgb` treats the end
    of each row apart)."""
    def run(img):
        return np.concatenate([fn(img[r:r + 32]) for r in range(0, img.shape[0], 32)])

    run.__doc__ = fn.__doc__
    return run


# ---------------------------------------------------------------------------
# HSV
# ---------------------------------------------------------------------------


@functools.cache
def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << 12) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << 12) / (6.0 * i))]).astype(np.int64)
    return sdiv, hdiv


@_by_rows
def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    sdiv, hdiv = _hsv_tables()
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = _descale(diff * sdiv[v], 12)
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = _descale(h * hdiv[diff], 12)
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fma(a, b, c):
    """a * b + c rounded once to float32."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(F32)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
SIMD_PIXELS = 32  # pixels of OpenCV's HSV -> RGB vector loop a step (AVX2)


@_by_rows
def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """OpenCV's vector loop takes SIMD_PIXELS pixels a step; the last
    (width % SIMD_PIXELS) pixels of a row take its scalar loop."""
    h = hsv[..., 0].astype(F32) * F32(6.0 / 180)
    s = hsv[..., 1].astype(F32) * F32(1 / 255.0)
    v = hsv[..., 2].astype(F32) * F32(1 / 255.0)
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64) % 6
    one = F32(1)
    tab = [v, v * (one - s), v * _fma(-s, h, 1.0), v * _fma(-s, one - h, 1.0)]
    out = np.stack([np.choose(_SECTORS[:, k][sector], tab) for k in (2, 1, 0)], axis=-1) * F32(255)
    vector = hsv.shape[-2] - hsv.shape[-2] % SIMD_PIXELS
    out[..., :vector, :] = np.trunc(out[..., :vector, :])
    out[..., vector:, :] = np.rint(out[..., vector:, :])
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Lab (sRGB, D65)
# ---------------------------------------------------------------------------

LAB_SHIFT, GAMMA_SHIFT, BASE_SHIFT, INV_GAMMA_SHIFT = 12, 3, 14, 12
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
BASE = 1 << BASE_SHIFT
SRGB2XYZ = np.array([0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
                     0.019334, 0.119193, 0.950227]).reshape(3, 3)
XYZ2SRGB = np.array([3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
                     0.055648, -0.204043, 1.057311]).reshape(3, 3)
WHITE_D65 = np.array([0.950456, 1.0, 1.088754])
MIN_AB = -8145


def _trunc_f32(x: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero (x >= 0)."""
    c = x.astype(F32)
    return np.where(c.astype(np.float64) > x, np.nextafter(c, F32(0)), c)


@functools.cache
def _lab_tables():
    i = np.arange(256) / 255.0
    gamma = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255.0 * (1 << GAMMA_SHIFT) * gamma).astype(np.int64)
    # the cube root's float32 result rounds toward zero, which settles the
    # entries that fall on a half at 2^15
    x = F32(1.0 / (255 * (1 << GAMMA_SHIFT))) * np.arange(256 * 3 // 2 * (1 << GAMMA_SHIFT)).astype(F32)
    lin = _fma(x, np.full_like(x, F32(841 / 108)), float(F32(16 / 116)))
    f = np.where(x < F32(216 / 24389), lin, _trunc_f32(np.cbrt(x.astype(np.float64))))
    cbrt_tab = np.rint(F32(1 << LAB_SHIFT2) * f).astype(np.int64)
    to_xyz = np.rint(SRGB2XYZ * ((1 << LAB_SHIFT) / WHITE_D65)[:, None]).astype(np.int64)

    li = np.arange(256) * 100.0 / 255.0
    low = np.arange(256) <= 20
    yy = np.where(low, li / (24389 / 27), ((li + 16) / 116) ** 3)
    fy = np.where(low, (841 / 108) * yy + 16 / 116, (li + 16) / 116)
    l_to_y, l_to_fy = np.rint(yy * BASE).astype(np.int64), np.rint(fy * BASE).astype(np.int64)
    k = np.arange(MIN_AB, 2 * BASE - MIN_AB, dtype=np.int64)
    low_xz = np.trunc(k * 108 / 841).astype(np.int64) - (BASE * 16 // 116 * 108 // 841)
    ab_to_xz = np.where(k <= 3390, low_xz, (k * k // BASE) * k // BASE)
    size = 1 << INV_GAMMA_SHIFT
    x = np.arange(size) / size
    inv_gamma = np.rint(255 * np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055))
    to_rgb = np.rint((1 << LAB_SHIFT) * XYZ2SRGB * WHITE_D65[None, :]).astype(np.int64)
    return gamma_tab, cbrt_tab, to_xyz, l_to_y, l_to_fy, ab_to_xz, inv_gamma.astype(np.int64), to_rgb


@_by_rows
def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    gamma_tab, cbrt_tab, c, *_ = _lab_tables()
    r, g, b = (gamma_tab[rgb[..., k]] for k in range(3))
    fx, fy, fz = (cbrt_tab[_descale(r * c[k, 0] + g * c[k, 1] + b * c[k, 2], LAB_SHIFT)]
                  for k in range(3))
    lscale, lshift = (116 * 255 + 50) // 100, -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)
    L = _descale(lscale * fy + lshift, LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    b = _descale(200 * (fy - fz) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    return np.clip(np.stack([L, a, b], axis=-1), 0, 255).astype(np.uint8)


@_by_rows
def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    *_, l_to_y, l_to_fy, ab_to_xz, inv_gamma, c = _lab_tables()
    L, a, b = (lab[..., k].astype(np.int64) for k in range(3))
    y, fy = l_to_y[L], l_to_fy[L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * BASE // 200 + 1
    x, z = ab_to_xz[fy + adiv - MIN_AB], ab_to_xz[fy - bdiv - MIN_AB]
    shift = LAB_SHIFT + BASE_SHIFT - INV_GAMMA_SHIFT
    out = [inv_gamma[np.clip(_descale(c[k, 0] * x + c[k, 1] * y + c[k, 2] * z, shift),
                             0, (1 << INV_GAMMA_SHIFT) - 1)] for k in range(3)]
    return np.stack(out, axis=-1).astype(np.uint8)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------


def clahe(src: np.ndarray, clip: float = 4.0, tiles: int = 8) -> np.ndarray:
    """Contrast-limited adaptive histogram equalisation of a uint8 (h, w)
    image on a tiles x tiles grid. An image whose sides are not both
    multiples of `tiles` is extended by reflection (101) by `tiles` minus
    the remainder on each side, as OpenCV does, a whole tile where the
    remainder is 0."""
    h, w = src.shape
    ext = src
    if h % tiles or w % tiles:
        ext = np.pad(src, ((0, tiles - h % tiles), (0, tiles - w % tiles)), mode="reflect")
    th, tw = ext.shape[0] // tiles, ext.shape[1] // tiles
    area = th * tw
    n = tiles * tiles
    cells = ext.reshape(tiles, th, tiles, tw).transpose(0, 2, 1, 3).reshape(n, area).astype(np.int64)
    hist = np.zeros((n, 256), np.int64)
    np.add.at(hist, (np.repeat(np.arange(n), area), cells.ravel()), 1)
    if clip > 0:
        limit = max(int(clip * area / 256), 1)
        clipped = np.maximum(hist - limit, 0).sum(axis=1)
        hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
        for t, residual in enumerate((clipped % 256).tolist()):
            if residual:
                hist[t, ::max(256 // residual, 1)][:residual] += 1
    lut = np.clip(np.rint(np.cumsum(hist, axis=1).astype(F32) * F32(255.0 / area)), 0, 255)

    def axis(size, step):
        t = np.arange(size).astype(F32) * (F32(1) / F32(step)) - F32(0.5)
        t1 = np.floor(t).astype(np.int64)
        frac = t - t1.astype(F32)
        return np.maximum(t1, 0), np.minimum(t1 + 1, tiles - 1), frac, F32(1) - frac

    tx1, tx2, xa, xa1 = axis(w, tw)
    ty1, ty2, ya, ya1 = axis(h, th)
    s = src.astype(np.int64)
    tap = lambda ty, tx: lut[ty[:, None] * tiles + tx[None, :], s].astype(F32)
    res = ((tap(ty1, tx1) * xa1 + tap(ty1, tx2) * xa) * ya1[:, None]
           + (tap(ty2, tx1) * xa1 + tap(ty2, tx2) * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
