"""The port's LSD (`csrc/lsd.cpp`, built by the host compiler) against
OpenCV 5's `createLineSegmentDetector(LSD_REFINE_ADV)`, which the JAX
package calls, on seeded images: polygons with straight edges from 64 x 48
to 640 x 480 and at 1600 x 1200, odd sizes, heavy noise, a smooth random field,
drawn lines, a flat image, and segments at the `min_length` edge.

The port is bit-equal to cv2 on all of them: the grey conversion, the
blurred and 0.8-resized image, and the raw output (the same segments in the
same order, with the same width, precision and NFA; the NFA counts a
rectangle's pixels as OpenCV 5's scanline walk does). The tests assert the
same count and order, every endpoint within 1e-3 px, the NFA within 1e-4,
width and precision within 1e-12 relative, and `detect_lsd_host` equal to
the JAX package's, array for array.
"""

import cv2
import numpy as np
import pytest

from gluefactory_tpu.models.lines.lsd import detect_lsd_host as jax_detect
from gluefactory_tpu_torch.models.lines import lsd


def polygons(h, w, seed, n=12, noise=12):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), rng.integers(0, 255), np.uint8)
    for _ in range(n):
        pts = rng.integers(0, [w, h], (rng.integers(3, 6), 2)).astype(np.int32)
        cv2.fillPoly(img, [pts], int(rng.integers(0, 255)))
    return cv2.add(img, rng.integers(0, noise, (h, w)).astype(np.uint8))


SIZES = [(48, 64, 0), (120, 160, 1), (97, 131, 2), (240, 320, 3), (480, 640, 4), (480, 640, 5)]


def _cv2(img):
    segs, width, prec, nfa = cv2.createLineSegmentDetector(cv2.LSD_REFINE_ADV).detect(img)
    if segs is None:
        return np.zeros((0, 4), np.float32), *(np.zeros(0) for _ in range(3))
    return segs.reshape(-1, 4), width.ravel(), prec.ravel(), nfa.ravel()


def test_grey_conversion_is_cv2s():
    rgb = (np.random.default_rng(0).random((123, 77, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(lsd.rgb_to_grey_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("h,w", [(5, 7), (48, 64), (97, 131), (120, 160), (480, 640)])
def test_scaled_image_is_cv2s(h, w):
    img = np.random.default_rng(h).integers(0, 256, (h, w)).astype(np.uint8)
    want = cv2.resize(cv2.GaussianBlur(img, (7, 7), 0.75), None, fx=0.8, fy=0.8,
                      interpolation=cv2.INTER_LINEAR_EXACT).astype(np.float64)
    np.testing.assert_array_equal(lsd.lsd_scaled(img), want)


def _assert_same(got, want):
    """The port's raw output equals cv2's: same count and order, endpoints
    within 1e-3 px, NFA within 1e-4, width and precision within 1e-12."""
    assert len(got[0]) == len(want[0])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3, err_msg="segments")
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4, err_msg="nfa")
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, err_msg="width")
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, err_msg="precision")


def test_segments_against_cv2():
    for h, w, seed in SIZES:
        img = polygons(h, w, seed)
        want = _cv2(img)
        assert len(want[0]) >= 10, (h, w)
        _assert_same(lsd.lsd_segments(img), want)


def _drawn_lines(rng):
    img = np.zeros((240, 320), np.uint8)
    for _ in range(30):
        p = rng.integers(0, [320, 240], (2, 2))
        cv2.line(img, tuple(map(int, p[0])), tuple(map(int, p[1])), int(rng.integers(50, 255)),
                 int(rng.integers(1, 4)))
    return img


@pytest.mark.parametrize("kind", ["large", "odd", "noise", "smooth", "lines"])
def test_raw_output_against_cv2_on_other_images(kind):
    rng = np.random.default_rng(7)
    img = {
        "large": lambda: polygons(1200, 1600, 30, n=30, noise=20),
        "odd": lambda: polygons(333, 517, 31, n=20, noise=30),
        "noise": lambda: polygons(241, 319, 32, noise=150),
        "smooth": lambda: cv2.resize(rng.integers(0, 256, (13, 17)).astype(np.uint8), (321, 241),
                                     interpolation=cv2.INTER_CUBIC),
        "lines": lambda: _drawn_lines(rng),
    }[kind]()
    want = _cv2(img)
    assert len(want[0]) >= 10
    _assert_same(lsd.lsd_segments(img), want)


def test_flat_and_tiny_images_give_no_segments():
    for img in (np.full((60, 80), 128, np.uint8), np.zeros((3, 3), np.uint8)):
        assert len(lsd.lsd_segments(img)[0]) == 0 and _cv2(img)[0].shape[0] == 0


def test_same_segments_twice():
    img = polygons(240, 320, 9)
    a, b = lsd.lsd_segments(img), lsd.lsd_segments(img)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("min_length", [15.0, 40.0])
def test_detect_lsd_host_against_jax(min_length):
    """The whole host detection, grey conversion and post-processing
    included, equal to the JAX package's on the six polygon images (64 x 48
    to 640 x 480, one odd size) in colour, and a flat one. The images hold segments
    just under and just over `min_length` (within 1 px), so the length
    filter's edge is crossed."""
    near, kept = [0, 0], 0
    imgs = [polygons(h, w, s) for h, w, s in SIZES] + [np.full((60, 80), 77, np.uint8)]
    for img in imgs:
        i = img.astype(np.int32)
        rgb = np.stack([i, np.minimum(i + 9, 255), np.maximum(i - 7, 0)], -1)[None]
        rgb = rgb.astype(np.float32) / 255
        segs = _cv2(cv2.cvtColor((rgb[0] * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY))[0]
        length = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
        near[0] += ((length >= min_length - 1) & (length < min_length)).sum()
        near[1] += ((length >= min_length) & (length <= min_length + 1)).sum()
        got = lsd.detect_lsd_host(rgb, 64, min_length)
        want = jax_detect(rgb, 64, min_length)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        n = got[2][0].sum()
        kept += n
        if n:
            assert got[1][0, :n].max() == 1.0
    assert min(near) > 0 and kept > 0, (near, kept)
