"""LSD line segments on the host (counterpart of
`gluefactory_tpu/models/lines/lsd.py`).

The detector is the repo's own C++ LSD (`csrc/lsd.cpp`, built by the host
compiler at first use, `ops/_build.py`), called through ctypes: OpenCV is not
used. Images are converted to grey as cv2's `COLOR_RGB2GRAY` converts
`(img * 255).astype(uint8)` (fixed-point weights, `rgb_to_grey_u8`), detected, then
post-processed in numpy as the JAX package does: segments shorter than
`min_length` dropped, score sqrt(length) * max(-log10 NFA, 0), the `max_lines`
best kept (`np.argsort(-scores)`), scores divided by the image's best.

A detection that fails raises: nothing degrades to "no lines". Several
images are detected at once in a thread pool (the C call releases the GIL).
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...ops import _build
from ..base_model import BaseModel

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load_host("lsd")
    lib.gf_lsd.argtypes = [_P, _I, _I, _I, _P, _P, _P, _P]
    lib.gf_lsd.restype = _I
    lib.gf_lsd_scaled.argtypes = [_P, _I, _I, _P]
    lib.gf_lsd_scaled.restype = _I
    return lib


def rgb_to_grey_u8(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> uint8 (H, W) grey, as cv2 5's COLOR_RGB2GRAY:
    weights in 1/2^15, rounded once."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


def lsd_segments(grey: np.ndarray):
    """The detector on a uint8 (H, W) image: segments (N, 4) float32 (x1, y1,
    x2, y2), and width, precision and -log10(NFA) (N,) float64."""
    grey = np.ascontiguousarray(grey, dtype=np.uint8)
    h, w = grey.shape
    lib = _lib()
    cap = 1024
    while True:
        segs = np.empty((cap, 4), np.float32)
        width, prec, nfa = (np.empty(cap, np.float64) for _ in range(3))
        n = lib.gf_lsd(grey.ctypes.data, h, w, cap, segs.ctypes.data, width.ctypes.data,
                       prec.ctypes.data, nfa.ctypes.data)
        if n < 0:
            raise RuntimeError(f"LSD failed on a {h}x{w} image")
        if n <= cap:
            return segs[:n], width[:n], prec[:n], nfa[:n]
        cap = n


def lsd_scaled(grey: np.ndarray) -> np.ndarray:
    """The blurred, 0.8-resized float64 image the detector works on."""
    grey = np.ascontiguousarray(grey, dtype=np.uint8)
    h, w = grey.shape
    out = np.empty((int(np.rint(h * 0.8)), int(np.rint(w * 0.8))), np.float64)
    if _lib().gf_lsd_scaled(grey.ctypes.data, h, w, out.ctypes.data) != 0:
        raise RuntimeError(f"LSD failed on a {h}x{w} image")
    return out


def _detect_one(img: np.ndarray, max_lines: int, min_length: float):
    if img.shape[-1] == 3:
        grey = rgb_to_grey_u8((img * 255).astype(np.uint8))
    else:
        grey = (img[..., 0] * 255).astype(np.uint8)
    segs, _, _, nfa = lsd_segments(grey)
    lines = np.zeros((max_lines, 2, 2), np.float32)
    scores = np.zeros(max_lines, np.float32)
    valid = np.zeros(max_lines, bool)
    if len(segs) == 0:
        return lines, scores, valid
    segs = segs.reshape(-1, 2, 2)
    lengths = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=-1)
    keep = lengths >= min_length
    segs, lengths = segs[keep], lengths[keep]
    s = np.sqrt(lengths) * np.maximum(nfa.reshape(-1)[keep], 0.0)
    order = np.argsort(-s)[:max_lines]
    n = len(order)
    lines[:n] = segs[order]
    scores[:n] = s[order]
    valid[:n] = True
    if n > 0 and scores[:n].max() > 0:
        scores[:n] /= scores[:n].max()
    return lines, scores, valid


# images detected by `detect_lsd_host` in this process (a loader worker
# counts its own): a training run on precomputed wireframes leaves the main
# process's count alone
detections = 0


def detect_lsd_host(images: np.ndarray, max_lines: int, min_length: float):
    """images (B, H, W, C) float [0, 1] -> (lines (B, L, 2, 2) xy, scores
    (B, L), valid (B, L)), one image a thread."""
    global detections
    B = images.shape[0]
    detections += B
    with ThreadPoolExecutor(max_workers=max(1, min(B, 8))) as pool:
        outs = list(pool.map(lambda b: _detect_one(images[b], max_lines, min_length), range(B)))
    return tuple(np.stack([o[i] for o in outs]) for i in range(3))


class LSD(BaseModel):
    default_conf = {
        "max_num_lines": 250,
        "min_length": 15.0,
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        pass

    def _forward(self, data: dict, train: bool = False, **kwargs) -> dict:
        image = data["image"]
        lines, scores, valid = detect_lsd_host(
            image.detach().float().cpu().numpy(), int(self.conf.max_num_lines),
            float(self.conf.min_length))
        dev = image.device
        return {"lines": torch.from_numpy(lines).to(dev),
                "line_scores": torch.from_numpy(scores).to(dev),
                "line_mask": torch.from_numpy(valid).to(dev)}

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError
