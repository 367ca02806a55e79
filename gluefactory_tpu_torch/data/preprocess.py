"""Reading and resizing images (counterpart of
`gluefactory_tpu/data/preprocess.py`), without OpenCV.

`read_image` gives what `cv2.imread(path, IMREAD_COLOR)` then BGR -> RGB
give, as float32 HWC RGB in [0, 1]: binary PPM / PGM (P6 / P5) parsed in
numpy; every other format (JPEG, PNG, ...) decoded by Pillow, which is
imported only here and whose JPEG decoder is libjpeg-turbo, as OpenCV's
is. As OpenCV does: an EXIF orientation (JPEG or PNG) is applied; grey,
grey + alpha and palette images become RGB; alpha is dropped; 16-bit
samples keep their high byte. A file that cannot be read raises `IOError`.

With `grayscale`, `read_image` gives what `cv2.imread(IMREAD_GRAYSCALE)`
gives as float32 HW1: a JPEG's luma as libjpeg decodes it (Pillow's draft
mode), a colour PNG by libpng's truncating weights ((9797 R + 19234 G +
3737 B) >> 15, grey pixels kept), every other format through cv2's
fixed-point BGR -> grey ((4899 R + 9617 G + 1868 B + 2^13) >> 14).

`resize_image` takes `linear` and `area` on float32 images:
- `linear` is `cv2.resize(INTER_LINEAR)`: pixel centres aligned
  ((x + 0.5) s - 0.5), the taps clamped at the edges, computed in float64
  (within an ulp of OpenCV's float32);
- `area` is `INTER_AREA` as OpenCV 5 computes it, bit for bit: at an
  integer downscale the block mean of `resizeAreaFast_` (sums by fours in
  row-major order, times 1/area in float32; a 2 x 2 mean of 1 or 4 channels
  in SSE's pairwise order on the columns of its 4-lane loop), at any other
  downscale the overlap weights of `computeResizeAreaTab` accumulated in
  float32 as `resizeArea_` does (source row by row, then rows); when an
  axis grows, the two-tap interpolation with the area-mode weights;
- `nearest` is `INTER_NEAREST` (not `INTER_NEAREST_EXACT`): destination
  index x takes source index floor(x / (dst / src)), in float64, clamped to
  the last one (the depth maps' resize).
`cubic` raises `NotImplementedError`.

`ImagePreprocessor` resizes by side (`short` / `long` / `vert` / `horz`),
trims to `edge_divisible_by`, downsamples with `area` under `antialias`,
and pads square (`square_pad`, with `padding_mask`) or to a multiple.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from ..core.config import Config, merge


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


def _read_pillow(path: Path, grayscale: bool = False) -> tuple[np.ndarray, str]:
    """The image as uint8 (h, w, 3), or (h, w, 1) for a JPEG's luma with
    `grayscale`, and its format."""
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(f"reading {path.suffix or 'this'} images needs Pillow (PIL), "
                          "which is not installed") from e
    try:
        with Image.open(path) as im:
            fmt = im.format
            if grayscale and fmt == "JPEG":
                im.draft("L", im.size)  # libjpeg's own luma, as cv2 decodes it
            im = ImageOps.exif_transpose(im)
            if grayscale and fmt == "JPEG" and im.mode == "L":
                arr = np.asarray(im)[..., None]
            elif im.mode in ("I;16", "I;16B", "I;16L", "I"):
                arr = np.asarray(im)
                arr = (arr >> 8 if arr.dtype.itemsize == 2 else np.clip(arr, 0, 65535) >> 8)
                arr = np.repeat(arr.astype(np.uint8)[..., None], 3, axis=-1)
            else:
                arr = np.asarray(im.convert("RGB"))
    except (OSError, ValueError, SyntaxError) as e:
        raise IOError(f"could not read image {path}: {e}") from e
    return arr, fmt


def _rgb2gray(rgb: np.ndarray, fmt: str) -> np.ndarray:
    """uint8 (h, w, 3) RGB -> (h, w, 1) grey as cv2's decoder of `fmt` makes
    it: libpng's for a PNG, cv2's own fixed-point weights otherwise."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    if fmt == "PNG":
        grey = np.where((r == g) & (r == b), r, (r * 9797 + g * 19234 + b * 3737) >> 15)
    else:
        grey = (r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14
    return grey.astype(np.uint8)[..., None]


def read_image(path: str | Path, grayscale: bool = False) -> np.ndarray:
    """Read an image as float32 HWC RGB (or HW1 grey) in [0, 1]."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise IOError(f"could not read image {path}") from e
    try:
        img = _read_netpbm(data)
    except ValueError as e:
        raise IOError(f"could not read image {path}: {e}") from e
    fmt = "PPM"
    if img is None:
        img, fmt = _read_pillow(path, grayscale)
    if grayscale:
        if img.shape[-1] == 3:
            img = _rgb2gray(img, fmt)
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(np.float32) / 255.0


def _linear_taps(dst: int, src: int, area: bool = False):
    """Source indices and weights of cv2's INTER_LINEAR along one axis; with
    `area`, the weights INTER_AREA takes when the image grows."""
    if area:
        i0 = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
        fx = (np.arange(dst) + 1) - (i0 + 1) * (dst / src)
        fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
    else:
        fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        i0 = np.floor(fx).astype(np.int64)
        fx = fx - i0
    clamp = (i0 < 0) | (i0 >= src - 1)
    fx[clamp] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), 1.0 - fx, fx


def _resize_linear(img: np.ndarray, nw: int, nh: int, area: bool = False) -> np.ndarray:
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(nw, w, area)
    y0, y1, b0, b1 = _linear_taps(nh, h, area)
    src = img.astype(np.float64).reshape(h, w, -1)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    return (rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]).astype(np.float32)


def _area_tab(ssize: int, dsize: int, scale: float):
    """cv2's `computeResizeAreaTab`: (output index, source index, float32
    weight, position among its output's entries) of every overlap."""
    tab = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        entries = [(s1 - 1, (s1 - f1) / cell)] if s1 - f1 > 1e-3 else []
        entries += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            entries.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        tab += [(d, s, a, p) for p, (s, a) in enumerate(entries)]
    d, s, a, p = (np.array(c) for c in zip(*tab))
    return d, s, a.astype(np.float32), p


def _accumulate(src: np.ndarray, axis: int, n_out: int, scale: float) -> np.ndarray:
    """`resizeArea_` along `axis` (0 rows, 1 columns) in float32: each output
    sums its weighted sources in the table's order."""
    d, s, a, p = _area_tab(src.shape[axis], n_out, scale)
    shape = list(src.shape)
    shape[axis] = n_out
    out = np.zeros(shape, np.float32)
    for pos in range(p.max() + 1):
        m = p == pos
        w = a[m].reshape((-1,) + (1,) * (src.ndim - 1 - axis))
        idx = (slice(None),) * axis + (d[m],)
        out[idx] = out[idx] + np.take(src, s[m], axis=axis) * w
    return out


def _area_fast(img: np.ndarray, ix: int, iy: int) -> np.ndarray:
    """`resizeAreaFast_`: the mean of each iy x ix block in float32."""
    h, w, c = img.shape
    nh, nw = h // iy, w // ix
    blocks = img.reshape(nh, iy, nw, ix, c).transpose(0, 2, 1, 3, 4).reshape(nh, nw, iy * ix, c)
    area = ix * iy
    total = np.zeros((nh, nw, c), np.float32)
    k = 0
    while k <= area - 4:  # the scalar loop, unrolled by four
        total = total + (((blocks[:, :, k] + blocks[:, :, k + 1]) + blocks[:, :, k + 2])
                         + blocks[:, :, k + 3])
        k += 4
    for k in range(k, area):
        total = total + blocks[:, :, k]
    out = total * np.float32(1.0 / area)
    if (ix, iy) == (2, 2) and c in (1, 4):
        # the SIMD loop over 4 floats: both rows' pairs added, then each row
        r0, r1 = img[0::2], img[1::2]
        pair = ((r0[:, 0::2] + r0[:, 1::2]) + (r1[:, 0::2] + r1[:, 1::2])) * np.float32(0.25)
        vec = (nw * c // 4) * 4 // c
        out[:, :vec] = pair[:, :vec]
    return out


def _resize_area(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    h, w = img.shape[:2]
    src = img.astype(np.float32).reshape(h, w, -1)
    sx, sy = 1.0 / (nw / w), 1.0 / (nh / h)
    if sx < 1 or sy < 1:
        return _resize_linear(src, nw, nh, area=True)
    ix, iy = round(sx), round(sy)
    if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
        return _area_fast(src, ix, iy)
    return _accumulate(_accumulate(src, 1, nw, sx), 0, nh, sy)


def _resize_nearest(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    h, w = img.shape[:2]

    def index(dst, src):
        return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)

    return img.reshape(h, w, -1)[index(nh, h)][:, index(nw, w)]


_RESIZE = {"linear": _resize_linear, "area": _resize_area, "nearest": _resize_nearest}


def resize_image(img: np.ndarray, size, interp: str = "linear"):
    """Resize to (w, h); returns (resized, scales (2,) new/old [x, y])."""
    if interp not in _RESIZE:
        raise NotImplementedError(f"resize_image: interpolation {interp!r} is not ported")
    h, w = img.shape[:2]
    nw, nh = int(size[0]), int(size[1])
    return _RESIZE[interp](img, nw, nh), np.array([nw / w, nh / h], dtype=np.float32)


class ImagePreprocessor:
    default_conf = {
        "resize": None,  # target size (int)
        "edge_divisible_by": None,
        "side": "long",  # among {short, long, vert, horz}
        "interpolation": "linear",
        "align_corners": None,  # unused (cv2 semantics); kept for conf parity
        "antialias": True,
        "square_pad": False,
        "add_padding_mask": False,
        # pad the image buffer with zeros to the next multiple; `image_size`
        # stays the true size
        "pad_to_multiple": None,
    }

    def __init__(self, conf=None):
        self.conf = merge(Config(self.default_conf), conf or {})

    def target_size(self, h: int, w: int):
        conf = self.conf
        if conf.resize is None:
            nw, nh = w, h
        else:
            if conf.side == "vert":
                scale = conf.resize / h
            elif conf.side == "horz":
                scale = conf.resize / w
            elif (conf.side == "short") ^ (w < h):
                scale = conf.resize / h
            else:
                scale = conf.resize / w
            nw, nh = int(round(w * scale)), int(round(h * scale))
        if conf.edge_divisible_by is not None:
            d = conf.edge_divisible_by
            nw, nh = (nw // d) * d, (nh // d) * d
        return nw, nh

    def __call__(self, img: np.ndarray) -> dict:
        """img: float32 HWC in [0, 1]. Returns image (H', W', C), image_size
        (2,) [w, h], scales (2,), original_image_size, transform (3, 3) and,
        with `square_pad`, padding_mask."""
        h, w = img.shape[:2]
        nw, nh = self.target_size(h, w)
        if (nw, nh) != (w, h):
            interp = self.conf.interpolation
            if self.conf.antialias and (nw < w or nh < h) and interp == "linear":
                interp = "area"  # cv2's antialiased downsampling
            img, scales = resize_image(img, (nw, nh), interp)
        else:
            scales = np.array([1.0, 1.0], dtype=np.float32)
        out = {
            "image": img,
            "image_size": np.array([img.shape[1], img.shape[0]], dtype=np.float32),
            "scales": scales,
            "original_image_size": np.array([w, h], dtype=np.float32),
            "transform": np.diag([scales[0], scales[1], 1.0]).astype(np.float32),
        }
        if self.conf.square_pad:
            side = max(img.shape[0], img.shape[1])
            out["image"] = _pad(img, side, side)
            mask = np.zeros((side, side), dtype=bool)
            mask[: img.shape[0], : img.shape[1]] = True
            out["padding_mask"] = mask
        if self.conf.pad_to_multiple:
            m = int(self.conf.pad_to_multiple)
            ih, iw = out["image"].shape[:2]
            out["image"] = _pad(out["image"], -(-ih // m) * m, -(-iw // m) * m)
        return out


def _pad(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """`img` in the top-left corner of an (h, w) zero image."""
    if img.shape[:2] == (h, w):
        return img
    padded = np.zeros((h, w, img.shape[2]), dtype=img.dtype)
    padded[: img.shape[0], : img.shape[1]] = img
    return padded
