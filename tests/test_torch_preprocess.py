"""The port's `read_image` (numpy for PPM / PGM, Pillow for the rest) and
`resize_image` against the JAX package's, which call cv2: images written by
cv2 (JPEG, 8- and 16-bit PNG, grey, PPM, PGM) and by Pillow (a palette PNG,
grey + alpha, an EXIF orientation in a JPEG and in a PNG) read bit-equal;
an unreadable or missing file raises IOError in both; `resize_image`
(linear) within 2 float32 ulps of 1; the interpolation not ported
(cubic) raises. `nearest`: `tests/test_torch_eval_posed.py`."""

import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from gluefactory_tpu.data import preprocess as J
from gluefactory_tpu_torch.data import preprocess as P


def _base(seed=0, shape=(37, 53, 3)):
    return np.clip(np.random.default_rng(seed).normal(128, 50, shape), 0, 255).astype(np.uint8)


def _exif(path, orientation):
    im = Image.fromarray(_base()[..., ::-1])
    ex = Image.Exif()
    ex[0x0112] = orientation
    im.save(path, exif=ex, **({"quality": 90} if path.suffix == ".jpg" else {}))


WRITERS = {
    "jpeg": ("a.jpg", lambda p: cv2.imwrite(str(p), _base())),
    "png8": ("a.png", lambda p: cv2.imwrite(str(p), _base())),
    "png16": ("a.png", lambda p: cv2.imwrite(str(p), _base().astype(np.uint16) * 257 + 99)),
    "rgba": ("a.png", lambda p: cv2.imwrite(str(p), np.concatenate([_base(), _base(1)[..., :1]], -1))),
    "grey_png": ("g.png", lambda p: cv2.imwrite(str(p), _base()[..., 0])),
    "grey16_png": ("g.png", lambda p: cv2.imwrite(str(p), _base()[..., 0].astype(np.uint16) * 255)),
    "grey_jpeg": ("g.jpg", lambda p: cv2.imwrite(str(p), _base()[..., 0])),
    "grey_alpha": ("la.png", lambda p: Image.fromarray(_base()[..., :2], "LA").save(p)),
    "palette": ("p.png", lambda p: Image.fromarray(_base()).convert(
        "P", palette=Image.ADAPTIVE, colors=17).save(p)),
    "ppm": ("a.ppm", lambda p: cv2.imwrite(str(p), _base())),
    "pgm": ("g.pgm", lambda p: cv2.imwrite(str(p), _base()[..., 0])),
    "exif3_jpeg": ("e.jpg", lambda p: _exif(p, 3)),
    "exif6_jpeg": ("e.jpg", lambda p: _exif(p, 6)),
    "exif8_png": ("e.png", lambda p: _exif(p, 8)),
    "exif5_png": ("e.png", lambda p: _exif(p, 5)),
}


@pytest.mark.parametrize("kind", list(WRITERS))
def test_read_image_bit_equal(tmp_path, kind):
    name, write = WRITERS[kind]
    path = tmp_path / name
    write(path)
    got, want = P.read_image(path), J.read_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_unreadable_and_missing_files_raise_ioerror(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    for path in (bad, tmp_path / "missing.png", tmp_path / "truncated.ppm"):
        if path.name == "truncated.ppm":
            path.write_bytes(b"P6\n40 30\n255\n" + bytes(10))
        for mod in (J, P):
            with pytest.raises(IOError):
                mod.read_image(path)


def test_without_pillow(tmp_path):
    """With Pillow absent, PPM still reads and a JPEG raises ImportError
    naming Pillow."""
    cv2.imwrite(str(tmp_path / "a.ppm"), _base())
    cv2.imwrite(str(tmp_path / "a.jpg"), _base())
    code = f"""
import sys
sys.modules["PIL"] = None
sys.modules["cv2"] = None
from gluefactory_tpu_torch.data.preprocess import read_image
assert read_image({str(tmp_path / 'a.ppm')!r}).shape == (37, 53, 3)
try:
    read_image({str(tmp_path / 'a.jpg')!r})
except ImportError as e:
    assert "Pillow" in str(e), e
else:
    raise AssertionError("no ImportError")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("src,dst", [((17, 23), (70, 41)), ((31, 50), (640, 480)),
                                     ((480, 640), (641, 481)), ((5, 7), (5, 7))])
def test_resize_linear(src, dst):
    img = np.random.default_rng(src[0]).random(src + (3,)).astype(np.float32)
    got, gs = P.resize_image(img, dst)
    want, ws = J.resize_image(img, dst)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(gs, ws)
    assert np.abs(got - want).max() <= 2 * np.finfo(np.float32).eps


CUBIC_SIZES = [((17, 23), (70, 41)), ((120, 160), (53, 37)), ((48, 64), (24, 32)),
               ((37, 53), (101, 13)), ((480, 640), (641, 481)), ((37, 53), (53, 37))]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", CUBIC_SIZES)
def test_resize_cubic(src, dst, channels):
    """cubic against cv2's INTER_CUBIC (the JAX package's call): upscales,
    downscales, mixed and the identity size, grey and RGB, within 3 float32
    ulps of 1 (the port sums in float64, OpenCV in float32)."""
    img = np.random.default_rng(src[0] + channels).random(src + (channels,)).astype(np.float32)
    got, gs = P.resize_image(img, dst, "cubic")
    want, ws = J.resize_image(img, dst, "cubic")
    assert got.shape == want.shape == dst[::-1] + (channels,) and got.dtype == want.dtype
    np.testing.assert_array_equal(gs, ws)
    assert np.abs(got.astype(np.float64) - want).max() <= 3 * np.finfo(np.float32).eps
    if dst == src[::-1]:
        np.testing.assert_array_equal(got, img)


def test_cubic_through_the_preprocessor():
    img = np.random.default_rng(5).random((75, 100, 3)).astype(np.float32)
    for conf in ({"resize": 160, "interpolation": "cubic"},
                 {"resize": 48, "interpolation": "cubic", "antialias": True}):
        got, want = P.ImagePreprocessor(conf)(img), J.ImagePreprocessor(conf)(img)
        assert set(got) == set(want)
        for k in ("image_size", "scales", "original_image_size", "transform"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["image"].shape == want["image"].shape
        assert np.abs(got["image"].astype(np.float64) - want["image"]).max() <= 3 * np.finfo(np.float32).eps


def test_not_ported_raise():
    """An interpolation neither package names raises."""
    for name in ("lanczos", "bicubic"):
        with pytest.raises(NotImplementedError, match=name):
            P.resize_image(np.zeros((4, 4, 3), np.float32), (8, 8), name)
