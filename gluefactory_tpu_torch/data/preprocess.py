"""Reading and resizing images (counterpart of
`gluefactory_tpu/data/preprocess.py`), without OpenCV.

`read_image` gives what `cv2.imread(path, IMREAD_COLOR)` then BGR -> RGB
give, as float32 HWC RGB in [0, 1]: binary PPM / PGM (P6 / P5) parsed in
numpy; every other format (JPEG, PNG, ...) decoded by Pillow, which is
imported only here and whose JPEG decoder is libjpeg-turbo, as OpenCV's
is. As OpenCV does: an EXIF orientation (JPEG or PNG) is applied; grey,
grey + alpha and palette images become RGB; alpha is dropped; 16-bit
samples keep their high byte. A file that cannot be read raises `IOError`.

`resize_image` takes `linear` only: `cv2.resize(INTER_LINEAR)` on a float32
image, pixel centres aligned ((x + 0.5) s - 0.5), the taps clamped at the
edges, computed in float64 (within an ulp of OpenCV's float32). The other
interpolations and `ImagePreprocessor` are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _read_netpbm(data: bytes):
    """A binary PGM (P5) or PPM (P6) as uint8 (h, w, C); None if `data` is
    not one. A broken one raises ValueError."""
    if data[:2] not in (b"P5", b"P6"):
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    channels = 3 if data[:2] == b"P6" else 1
    dtype = np.dtype(">u2") if maxval > 255 else np.uint8
    count = w * h * channels
    body = np.frombuffer(data, dtype, count, pos + 1).reshape(h, w, channels)
    if maxval != (255 if dtype == np.uint8 else 65535):
        body = (body.astype(np.float64) * (255.0 / maxval) + 0.5).astype(np.uint8)
    elif dtype != np.uint8:
        body = (body >> 8).astype(np.uint8)
    return body


def _read_pillow(path: Path) -> np.ndarray:
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(f"reading {path.suffix or 'this'} images needs Pillow (PIL), "
                          "which is not installed") from e
    try:
        with Image.open(path) as im:
            im = ImageOps.exif_transpose(im)
            if im.mode in ("I;16", "I;16B", "I;16L", "I"):
                arr = np.asarray(im)
                arr = (arr >> 8 if arr.dtype.itemsize == 2 else np.clip(arr, 0, 65535) >> 8)
                arr = np.repeat(arr.astype(np.uint8)[..., None], 3, axis=-1)
            else:
                arr = np.asarray(im.convert("RGB"))
    except (OSError, ValueError, SyntaxError) as e:
        raise IOError(f"could not read image {path}: {e}") from e
    return arr


def read_image(path: str | Path, grayscale: bool = False) -> np.ndarray:
    """Read an image as float32 HWC RGB in [0, 1]."""
    if grayscale:
        raise NotImplementedError("read_image(grayscale=True) is not ported yet")
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise IOError(f"could not read image {path}") from e
    try:
        img = _read_netpbm(data)
    except ValueError as e:
        raise IOError(f"could not read image {path}: {e}") from e
    if img is None:
        img = _read_pillow(path)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(np.float32) / 255.0


def _linear_taps(dst: int, src: int):
    """Source indices and weights of cv2's INTER_LINEAR along one axis."""
    fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(fx).astype(np.int64)
    fx = fx - i0
    clamp = (i0 < 0) | (i0 >= src - 1)
    fx[clamp] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), 1.0 - fx, fx


def resize_image(img: np.ndarray, size, interp: str = "linear"):
    """Resize to (w, h); returns (resized, scales (2,) new/old [x, y])."""
    if interp != "linear":
        raise NotImplementedError(f"resize_image: interpolation {interp!r} is not ported yet")
    h, w = img.shape[:2]
    nw, nh = int(size[0]), int(size[1])
    x0, x1, a0, a1 = _linear_taps(nw, w)
    y0, y1, b0, b1 = _linear_taps(nh, h)
    src = img.astype(np.float64).reshape(h, w, -1)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    out = (rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]).astype(np.float32)
    return out, np.array([nw / w, nh / h], dtype=np.float32)


class ImagePreprocessor:
    def __init__(self, conf=None):
        raise NotImplementedError("ImagePreprocessor is not ported yet")
