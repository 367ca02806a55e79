"""Photometric augmentations (counterpart of
`gluefactory_tpu/data/augmentations.py`) on float32 HWC RGB images in
[0, 1], with a numpy generator for reproducibility.

The families `identity`, `dark` (low-light: gamma, motion or Gaussian blur,
ISO noise, JPEG) and `lg` (LightGlue's recipe: hue, gamma, blur, noise,
CLAHE, JPEG, shading) draw from the generator exactly as the JAX package
does, the same calls with the same arguments, so that the draws after them
(the next view's homography) stay in step. The JAX package runs each
operation through OpenCV; here each is numpy arithmetic that repeats
OpenCV's:

- `apply_gamma`, `apply_iso_noise`: the same numpy calls;
- `apply_hue_shift`: uint8 RGB -> HSV -> RGB (`colour.py`), bit-equal;
- `apply_blur`: `GaussianBlur` with sigma 0, whose k = 3 / 5 / 7 kernels
  are OpenCV's fixed binomial table; separable, reflection 101; bit-equal
  but in the scalar tail of a 5- or 7-tap row pass, within 1e-6;
- `apply_motion_blur`: the line kernel rotated as `warpAffine` does
  (bilinear, zero outside; OpenCV 5 takes no 1/32-pixel table for float32
  images) and normalised, then `filter2D` with reflection 101; within 1e-5;
- `apply_jpeg`: libjpeg-turbo's round trip (`jpeg.py`), bit-equal;
- `apply_clahe`: uint8 RGB -> Lab, CLAHE on L, Lab -> RGB (`colour.py`),
  bit-equal;
- `random_shade`: the filled ellipses as `cv2.ellipse` rasterises them
  (`raster.fill_ellipse`), bit-equal, blurred by the 251-351 tap
  Gaussian with OpenCV's sigma for the size, by FFT along each axis;
  within 1e-5.

The small filters round as OpenCV's loops round float32 (fused
multiply-adds in its 8-float vector steps, plain float32 in a row's scalar
tail, which it sums in other orders); the shading's long Gaussian runs by
FFT in float64.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Config, merge
from . import colour
from .jpeg import jpeg_round_trip
from .raster import fill_ellipse

F32 = np.float32
# float32 lanes of OpenCV's filter loops a step (its AVX2 dispatch)
SIMD_FLOATS = 8
# getGaussianKernel's table for sizes 3, 5 and 7 with sigma <= 0
SMALL_GAUSSIAN = {
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def _to_u8(img):
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _to_f32(img):
    return img.astype(np.float32) / 255.0


def gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """`cv2.getGaussianKernel(ksize, sigma, CV_32F)` (as float64 values)."""
    if ksize in SMALL_GAUSSIAN and sigma <= 0:
        return np.array(SMALL_GAUSSIAN[ksize])
    sigma = sigma if sigma > 0 else ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k / k.sum()).astype(F32).astype(np.float64)


def reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT_101 index, reflected as often as needed."""
    if n == 1:
        return np.zeros_like(idx)
    idx = np.mod(idx, 2 * n - 2)
    return np.where(idx >= n, 2 * n - 2 - idx, idx)


def _fma(a, b, c):
    """a * b + c rounded once to float32."""
    out = np.multiply(a, b, dtype=np.float64)
    out += c
    return out.astype(F32)


ROWS_A_BLOCK = 32  # the filters run in blocks of rows that stay in cache


def _by_rows(fn, taps: list) -> np.ndarray:
    """fn of the taps, one block of ROWS_A_BLOCK rows at a time (fn is
    elementwise across its taps)."""
    h = taps[0].shape[0]
    out = np.empty(taps[0].shape, F32)
    for r in range(0, h, ROWS_A_BLOCK):
        out[r:r + ROWS_A_BLOCK] = fn([t[r:r + ROWS_A_BLOCK] for t in taps])
    return out


def _taps(img: np.ndarray, ksize: int, axis: int) -> list:
    """The ksize shifted views of a float32 image along `axis` (0: rows,
    1: columns), reflection 101."""
    n, r = img.shape[axis], ksize // 2
    padded = np.take(img, reflect101(np.arange(-r, n + r), n), axis=axis)
    return [padded[t:t + n] if axis == 0 else padded[:, t:t + n] for t in range(ksize)]


def _splice(out: np.ndarray, tail_fn, taps: list) -> np.ndarray:
    """OpenCV's filter loops take SIMD_FLOATS values of a row (its w * C
    floats) a step and the rest of the row through a scalar loop: the
    output's last (w * C) % SIMD_FLOATS values of each row replaced by
    `tail_fn` of the taps' values there."""
    h = out.shape[0]
    flat = out.reshape(h, -1)
    n = flat.shape[1]
    cut = n - n % SIMD_FLOATS
    if cut < n:
        c = n // out.shape[1]  # floats a pixel
        first = cut // c
        flat[:, cut:] = tail_fn([t[:, first:].reshape(h, -1)[:, cut - first * c:] for t in taps])
    return out


def _row_pass(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """OpenCV's symmetric small row filters (3, 5 taps) and its general
    row filter (7 taps), as their vector loops round them."""
    S, k = _taps(img, len(k), 1), k.astype(F32)
    if len(k) == 3:
        vector = lambda T: _fma(T[0] + T[2], k[0], T[1] * k[1])
        tail = lambda T: T[1] * k[1] + (T[0] + T[2]) * k[0]
    elif len(k) == 5:
        vector = lambda T: _fma(T[0] + T[4], k[0], _fma(T[2], k[2], (T[1] + T[3]) * k[1]))
        tail = lambda T: T[2] * k[2] + (T[1] + T[3]) * k[1] + (T[0] + T[4]) * k[0]
    else:
        def vector(T):
            acc = T[0] * k[0]
            for t in range(1, len(k)):
                acc = _fma(T[t], k[t], acc)
            return acc
        tail = vector
    return _splice(_by_rows(vector, S), tail, S)


def _column_pass(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """OpenCV's symmetric column filter: the centre tap, then each pair of
    taps summed and multiply-added (plain float32 in its scalar loop)."""
    S, k = _taps(img, len(k), 0), k.astype(F32)
    r = len(k) // 2

    def vector(T):
        acc = T[r] * k[r]
        for j in range(1, r + 1):
            acc = _fma(T[r - j] + T[r + j], k[r + j], acc)
        return acc

    def tail(T):
        acc = T[r] * k[r]
        for j in range(1, r + 1):
            acc = acc + (T[r - j] + T[r + j]) * k[r + j]
        return acc

    return _splice(_by_rows(vector, S), tail, S)


def _fast_fft_size(n: int) -> int:
    """The least 2^a 3^b 5^c >= n."""
    best, p2 = 1 << max(n - 1, 0).bit_length(), 1
    while p2 < best:
        p3 = p2
        while p3 < best:
            p5 = p3
            while p5 < n:
                p5 *= 5
            best = min(best, p5)
            p3 *= 3
        p2 *= 2
    return best


def _correlate_fft(img: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """Correlation along `axis` with a long centred kernel, reflection 101,
    by FFT in float64."""
    n, r = img.shape[axis], len(kernel) // 2
    padded = np.take(img.astype(np.float64), reflect101(np.arange(-r, n + r), n), axis=axis)
    size = _fast_fft_size(n + 2 * r + len(kernel))
    shape = [1] * img.ndim
    shape[axis] = -1
    spec = np.fft.rfft(padded, size, axis=axis) * np.fft.rfft(kernel[::-1], size).reshape(shape)
    return np.take(np.fft.irfft(spec, size, axis=axis), np.arange(2 * r, 2 * r + n), axis=axis)


def gaussian_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """`cv2.GaussianBlur(img, (ksize, ksize), 0)` of a float32 image: the
    row pass stored as float32, then the column pass. Sizes 3, 5 and 7 as
    OpenCV's loops round them; a longer kernel by FFT in float64."""
    k = gaussian_kernel(ksize)
    if ksize in SMALL_GAUSSIAN:
        return _column_pass(_row_pass(img.astype(F32), k), k)
    rows = _correlate_fft(img, k, 1).astype(F32)
    return _correlate_fft(rows, k, 0).astype(F32)


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """`cv2.getRotationMatrix2D`."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(img: np.ndarray, M: np.ndarray) -> np.ndarray:
    """`cv2.warpAffine(img, M, (w, h))` of a small float32 (h, w) image onto
    itself, as OpenCV 5's scalar loop computes it (a row of the motion-blur
    kernel is shorter than its vector loop): M inverted in float64 and
    rounded to float32; source point fma(M0, x, M1 y) + M2 in float32;
    bilinear taps, zero outside, blended by fused multiply-adds."""
    h, w = img.shape
    A = M[:, :2]
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    inv = np.array([[A[1, 1], -A[0, 1]], [-A[1, 0], A[0, 0]]]) * (1.0 / det if det != 0 else 0.0)
    m = np.concatenate([inv, (-inv @ M[:, 2])[:, None]], axis=1).astype(F32)
    ys, xs = np.mgrid[0:h, 0:w].astype(F32)
    sx = _fma(m[0, 0], xs, m[0, 1] * ys) + m[0, 2]
    sy = _fma(m[1, 0], xs, m[1, 1] * ys) + m[1, 2]
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    a, b = sx - x0.astype(F32), sy - y0.astype(F32)

    def tap(y, x):
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        return np.where(inside, img[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)], F32(0))

    p00, p01, p10, p11 = tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top, bottom = _fma(a, p01 - p00, p00), _fma(a, p11 - p10, p10)
    return _fma(b, bottom - top, top)


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`cv2.filter2D(img, -1, kernel)` of a float32 image: correlation
    with the kernel centred, reflection 101, summed over the kernel's
    non-zero taps in row-major order from 0 by fused multiply-adds (plain
    float32 in OpenCV's scalar loop)."""
    kh, kw = kernel.shape
    h, w = img.shape[:2]
    rows = reflect101(np.arange(-(kh // 2), h + kh // 2), h)
    cols = reflect101(np.arange(-(kw // 2), w + kw // 2), w)
    padded = img.astype(F32)[rows][:, cols]
    taps = [(padded[i:i + h, j:j + w], kernel[i, j])
            for i in range(kh) for j in range(kw) if kernel[i, j] != 0]

    def vector(T):
        acc = np.zeros(T[0].shape, F32)
        for x, (_, k) in zip(T, taps):
            acc = _fma(x, k, acc)
        return acc

    def tail(T):
        acc = np.zeros_like(T[0])
        for x, (_, k) in zip(T, taps):
            acc = acc + x * k
        return acc

    views = [x for x, _ in taps]
    return _splice(_by_rows(vector, views), tail, views)


def apply_gamma(img, gamma):
    return np.clip(img, 0, 1) ** gamma


def apply_hue_shift(img, delta):
    """delta in OpenCV hue units (hue is [0, 180))."""
    hsv = colour.rgb_to_hsv(_to_u8(img)).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(delta)) % 180
    return _to_f32(colour.hsv_to_rgb(hsv.astype(np.uint8)))


def apply_blur(img, ksize):
    return gaussian_blur(img, max(int(ksize) | 1, 3))


def apply_motion_blur(img, ksize, angle):
    k = max(int(ksize) | 1, 3)
    kernel = np.zeros((k, k), np.float32)
    kernel[k // 2, :] = 1.0
    kernel = warp_affine(kernel, rotation_matrix((k / 2 - 0.5, k / 2 - 0.5), angle))
    kernel = kernel / max(kernel.sum(), 1e-6)
    return filter2d(img, kernel)


def apply_iso_noise(img, rng, color_shift=0.02, intensity=0.1):
    """Approximate ISO noise: luminance Poisson-ish + chroma gaussian."""
    noise_l = rng.normal(0.0, intensity * 0.1, img.shape[:2])[..., None]
    noise_c = rng.normal(0.0, color_shift, img.shape)
    return np.clip(img + noise_l + noise_c, 0, 1).astype(np.float32)


def apply_jpeg(img, quality):
    return _to_f32(jpeg_round_trip(_to_u8(img), int(quality)))


def apply_clahe(img, clip=4.0):
    lab = colour.rgb_to_lab(_to_u8(img))
    lab[..., 0] = colour.clahe(lab[..., 0], clip)
    return _to_f32(colour.lab_to_rgb(lab))


def random_shade(img, rng, nb_ellipses=20, transparency_range=(-0.5, 0.8),
                 kernel_size_range=(250, 350)):
    """Random additive ellipse shading."""
    h, w = img.shape[:2]
    min_dim = min(h, w) / 4
    mask = np.zeros((h, w), np.uint8)
    for _ in range(nb_ellipses):
        ax = int(max(rng.random() * min_dim, min_dim / 5))
        ay = int(max(rng.random() * min_dim, min_dim / 5))
        max_rad = max(ax, ay)
        x = rng.integers(max_rad, max(w - max_rad, max_rad + 1))
        y = rng.integers(max_rad, max(h - max_rad, max_rad + 1))
        angle = rng.random() * 90
        fill_ellipse(mask, (int(x), int(y)), (ax, ay), angle, 255)
    transparency = rng.uniform(*transparency_range)
    ks = int(rng.integers(*kernel_size_range))
    if (ks % 2) == 0:
        ks += 1
    mask = gaussian_blur(mask.astype(np.float32), ks)
    out = img * (1 - transparency * mask[..., None] / 255.0)
    return np.clip(out, 0, 1).astype(np.float32)


class BaseAugmentation:
    default_conf: dict = {"p": 1.0}

    def __init__(self, conf=None):
        self.conf = merge(Config(self.default_conf), conf or {})

    def __call__(self, image: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        """A grayscale image (C = 1) is repeated to three channels first."""
        if rng is None:
            rng = np.random.default_rng()
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        return self.apply(image, rng)

    def apply(self, image, rng):
        return image


class IdentityAugmentation(BaseAugmentation):
    pass


class DarkAugmentation(BaseAugmentation):
    """Low-light simulation."""

    default_conf = {"p": 0.75}

    def apply(self, image, rng):
        if rng.random() < self.conf.p:
            image = apply_gamma(image, rng.uniform(1.5, 3.0))
            if rng.random() < 0.5:
                image = apply_motion_blur(image, rng.integers(3, 8), rng.uniform(0, 360))
            elif rng.random() < 0.5:
                image = apply_blur(image, rng.integers(3, 7))
            if rng.random() < 0.5:
                image = apply_iso_noise(image, rng)
            if rng.random() < 0.7:
                image = apply_jpeg(image, rng.integers(10, 60))
        return image.astype(np.float32)


class LGAugmentation(BaseAugmentation):
    """LightGlue's training augmentation."""

    default_conf = {"p": 0.95}

    def apply(self, image, rng):
        if rng.random() < self.conf.p:
            if rng.random() < 0.5:
                image = apply_hue_shift(image, rng.integers(-15, 15))
            if rng.random() < 0.5:
                image = apply_gamma(image, rng.uniform(0.6, 1.6))
            r = rng.random()
            if r < 0.2:
                image = apply_blur(image, rng.integers(3, 7))
            elif r < 0.4:
                image = apply_motion_blur(image, rng.integers(3, 8), rng.uniform(0, 360))
            if rng.random() < 0.3:
                image = apply_iso_noise(image, rng)
            if rng.random() < 0.3:
                image = apply_clahe(image)
            if rng.random() < 0.3:
                image = apply_jpeg(image, rng.integers(30, 90))
            if rng.random() < 0.2:
                image = random_shade(image, rng)
        return image.astype(np.float32)


augmentations = {
    "identity": IdentityAugmentation,
    "dark": DarkAugmentation,
    "lg": LGAugmentation,
}
