"""The progressive probabilistic Hough transform on the host, as OpenCV's
`HoughLinesP` computes it.

The transform is the repo's own C++ (`csrc/hough.cpp`, built by the host
compiler at first use, `ops/_build.py`), called through ctypes: OpenCV is not
used. It repeats OpenCV's random visiting order, float rounding and fixed-
point walk, so its segments are OpenCV's, in OpenCV's order. The C code keeps
no state between calls, so threads may call it at once.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def _lib():
    lib = _build.load_host("hough")
    lib.gf_hough_lines_p.argtypes = [_P, _I, _I, _D, _D, _I, _D, _D, _I, _P]
    lib.gf_hough_lines_p.restype = _I
    return lib


def hough_lines_p(mask: np.ndarray, rho: float, theta: float, threshold: int,
                  min_line_length: float = 0.0, max_line_gap: float = 0.0) -> np.ndarray:
    """Segments of a uint8 (H, W) mask (nonzero = on): (N, 4) int32 `x1 y1 x2
    y2` in array indices, as `cv2.HoughLinesP(mask, rho, theta, threshold,
    minLineLength=min_line_length, maxLineGap=max_line_gap)` gives them
    (reshaped from (N, 1, 4); N = 0 where cv2 returns None)."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"the mask must be (H, W), got {mask.shape}")
    h, w = mask.shape
    lib = _lib()
    cap = 256
    while True:
        out = np.empty((cap, 4), np.int32)
        n = lib.gf_hough_lines_p(mask.ctypes.data, h, w, float(rho), float(theta), int(threshold),
                                 float(min_line_length), float(max_line_gap), cap, out.ctypes.data)
        if n < 0:
            raise RuntimeError(f"HoughLinesP failed on a {h}x{w} mask")
        if n <= cap:
            return out[:n]
        cap = n
