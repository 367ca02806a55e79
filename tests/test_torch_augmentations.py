"""The port's photometric augmentations (numpy arithmetic, no OpenCV)
against the JAX package's, which call cv2, on the same numpy inputs and
generators.

Bounds, per operation:
- bit-equal: gamma, ISO noise, the hue shift (uint8 RGB -> HSV -> RGB),
  the JPEG round trip (every quality the families draw), CLAHE (uint8 RGB ->
  Lab, CLAHE on L, Lab -> RGB), the filled-ellipse mask of the shading, and
  the colour conversions alone;
- within 1e-6: the Gaussian blur (sizes 3, 5, 7; bit-equal where a row's
  float count is a multiple of OpenCV's 8-float vector step, as at 128 and
  640 pixels);
- within 1e-5: the motion blur and the shading (the 251-351 tap Gaussian,
  which the port runs by FFT in float64).
The families `dark` and `lg` over 40 seeds at 96 x 128 and two at 480 x
640: the generator's state after the call equal, the outputs within 1e-5,
the largest of their operations' bounds.
"""

import cv2
import numpy as np
import pytest

from gluefactory_tpu.data import augmentations as J
from gluefactory_tpu_torch.data import augmentations as P
from gluefactory_tpu_torch.data import colour, raster
from gluefactory_tpu_torch.data.homographies import generate_synthetic_image

SIZES = [(96, 128), (97, 131), (61, 45), (480, 640)]


def image(seed, size=(96, 128)):
    h, w = size
    return generate_synthetic_image(seed, (w, h))


def colours(seed=0):
    """Every colour of a stride-5 grid and 300k random ones, (n, 1, 3) uint8."""
    v = np.arange(0, 256, 5, dtype=np.uint8)
    grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    rand = np.random.default_rng(seed).integers(0, 256, (300_000, 3)).astype(np.uint8)
    out = np.concatenate([grid, rand])
    return out[: len(out) // 256 * 256].reshape(-1, 256, 3)


@pytest.mark.parametrize("name,code,fn", [
    ("rgb2hsv", cv2.COLOR_RGB2HSV, colour.rgb_to_hsv),
    ("hsv2rgb", cv2.COLOR_HSV2RGB, colour.hsv_to_rgb),
    ("rgb2lab", cv2.COLOR_RGB2LAB, colour.rgb_to_lab),
    ("lab2rgb", cv2.COLOR_LAB2RGB, colour.lab_to_rgb),
], ids=lambda x: x if isinstance(x, str) else "")
def test_colour_conversions_bit_equal(name, code, fn):
    src = colours()
    if name == "hsv2rgb":
        src[..., 0] %= 180
    np.testing.assert_array_equal(fn(src), cv2.cvtColor(src, code))


@pytest.mark.parametrize("width", [97, 131, 45, 128])
def test_hsv_to_rgb_vector_and_scalar_loops(width):
    """OpenCV truncates in its vector loop and rounds in its scalar loop
    over the rest of each row."""
    rng = np.random.default_rng(width)
    hsv = np.stack([rng.integers(0, 180, (300, width)), rng.integers(0, 256, (300, width)),
                    rng.integers(0, 256, (300, width))], -1).astype(np.uint8)
    np.testing.assert_array_equal(colour.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("size", SIZES + [(480, 481), (64, 64)])
def test_clahe_bit_equal(size):
    rng = np.random.default_rng(size[1])
    src = np.clip(rng.normal(128, 60, size) * np.linspace(0.2, 1, size[1])[None], 0, 255)
    for img in (src.astype(np.uint8), (src // 32 * 32).astype(np.uint8)):
        want = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(img)
        np.testing.assert_array_equal(colour.clahe(img, 4.0), want)


@pytest.mark.parametrize("size", SIZES)
def test_gamma_noise_hue_clahe_bit_equal(size):
    img = image(size[1], size)
    np.testing.assert_array_equal(P.apply_gamma(img, 1.7), J.apply_gamma(img, 1.7))
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(P.apply_iso_noise(img, r1), J.apply_iso_noise(img, r2))
    assert r1.bit_generator.state == r2.bit_generator.state
    for delta in (-15, -3, 0, 7, 14):
        np.testing.assert_array_equal(P.apply_hue_shift(img, delta), J.apply_hue_shift(img, delta))
    np.testing.assert_array_equal(P.apply_clahe(img), J.apply_clahe(img))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("quality", [10, 30, 59, 60, 89])
def test_jpeg_bit_equal(size, quality):
    img = image(quality + size[0], size) ** 1.5
    np.testing.assert_array_equal(P.apply_jpeg(img, quality), J.apply_jpeg(img, quality))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ksize", [3, 4, 5, 6])
def test_blur_within_1e6(size, ksize):
    img = (image(ksize, size) ** 1.3).astype(np.float32)
    got, want = P.apply_blur(img, ksize), J.apply_blur(img, ksize)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6
    if size[1] * 3 % 8 == 0:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ksize", [3, 4, 5, 7])
def test_motion_blur_within_1e5(size, ksize):
    img = image(ksize + 10, size)
    for angle in np.random.default_rng(ksize).uniform(0, 360, 4):
        got, want = P.apply_motion_blur(img, ksize, angle), J.apply_motion_blur(img, ksize, angle)
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5, angle


def test_motion_blur_kernel_bit_equal():
    """The rotated line kernel is cv2.warpAffine's to the bit."""
    rng = np.random.default_rng(0)
    for k in (3, 5, 7) * 30:
        kernel = np.zeros((k, k), np.float32)
        kernel[k // 2] = 1
        angle = rng.uniform(0, 360)
        M = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0)
        np.testing.assert_array_equal(P.rotation_matrix((k / 2 - 0.5, k / 2 - 0.5), angle), M)
        np.testing.assert_array_equal(P.warp_affine(kernel, M), cv2.warpAffine(kernel, M, (k, k)))


def test_ellipse_mask_bit_equal():
    """`raster.fill_ellipse` against cv2.ellipse(..., -1): the shading's
    axes and centres, small axes (other vertex steps), ellipses across the
    border (clipped edges) and any angle."""
    rng = np.random.default_rng(0)
    for t in range(600):
        h, w = (480, 640) if t % 2 else (96, 128)
        min_dim = min(h, w) / 4
        if t % 5 == 0:
            axes = tuple(int(a) for a in rng.integers(0, 20, 2))
        else:
            axes = tuple(int(max(rng.random() * min_dim, min_dim / 5)) for _ in range(2))
        center = tuple(int(a) for a in rng.integers(-20, [w + 20, h + 20]))
        angle = rng.random() * 90 if t % 3 else rng.random() * 400 - 20
        want = np.zeros((h, w), np.uint8)
        cv2.ellipse(want, center, axes, angle, 0, 360, 255, -1)
        got = np.zeros((h, w), np.uint8)
        raster.fill_ellipse(got, center, axes, angle, 255)
        np.testing.assert_array_equal(got, want, err_msg=str((center, axes, angle)))


@pytest.mark.parametrize("size", SIZES)
def test_shade_within_1e5(size):
    img = image(3, size)
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = P.random_shade(img, r1), J.random_shade(img, r2)
        assert r1.bit_generator.state == r2.bit_generator.state
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("family", ["dark", "lg"])
@pytest.mark.parametrize("size,seeds", [((96, 128), range(40)), ((480, 640), (100, 101))],
                         ids=["96x128", "480x640"])
def test_family_matches_jax(family, size, seeds):
    for seed in seeds:
        img = image(seed, size)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = P.augmentations[family]()(img, r1)
        want = J.augmentations[family]()(img, r2)
        assert r1.bit_generator.state == r2.bit_generator.state, seed
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5, seed


def test_family_conf_and_grayscale():
    """The dataset's `p` overrides the class default; a grey image is
    repeated to three channels first, as in JAX."""
    img = image(0)[..., :1]
    for family in ("dark", "lg"):
        for p in (0.0, 1.0):
            r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
            got = P.augmentations[family]({"p": p})(img, r1)
            want = J.augmentations[family]({"p": p})(img, r2)
            assert got.shape == want.shape == img.shape[:2] + (3,)
            assert np.abs(got - want).max() <= 1e-5
            assert r1.bit_generator.state == r2.bit_generator.state
