"""ctypes bindings of the in-repo C++ LO-RANSAC library (counterpart of
`gluefactory_tpu/robust_estimators/native.py`), the estimators behind the
`poselib` names.

The library is the port's copy of the JAX package's `native/fastransac.cpp`
(`csrc/fastransac.cpp`), built by the host compiler at first use into
`build/torch_ext/` (`ops/_build.py::build_host`), never into `native/`. The
C entry points and their arguments are the JAX package's, so a seed gives
the same hypotheses. The C code keeps no state between calls.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_DP = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed, its entry points typed."""
    lib = _build.load_host("fastransac")
    lib.ransac_homography_cpp.restype = _I64
    lib.ransac_homography_cpp.argtypes = [_DP, _DP, _I64, ctypes.c_double, _I64, ctypes.c_uint64,
                                          _DP, _U8P]
    lib.ransac_essential_cpp.restype = _I64
    lib.ransac_essential_cpp.argtypes = [_DP, _DP, _I64, ctypes.c_double, _I64, ctypes.c_uint64,
                                         _DP, _DP, _U8P]
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def ransac_homography_native(pts0, pts1, th: float, max_iters: int = 2000, seed: int = 0):
    """LO-RANSAC homography of pixel matches (N, 2) -> (H (3, 3), inlier
    mask (N,), inlier count)."""
    p0 = np.ascontiguousarray(pts0, np.float64)
    p1 = np.ascontiguousarray(pts1, np.float64)
    H = np.zeros(9, np.float64)
    inliers = np.zeros(len(p0), np.uint8)
    num = get_lib().ransac_homography_cpp(_dp(p0), _dp(p1), len(p0), float(th), int(max_iters),
                                          int(seed), _dp(H), inliers.ctypes.data_as(_U8P))
    return H.reshape(3, 3), inliers.astype(bool), int(num)


def ransac_essential_native(p0n, p1n, th: float, max_iters: int = 2000, seed: int = 0):
    """LO-RANSAC relative pose of normalized matches (N, 2) -> (R (3, 3), t
    (3,), inlier mask (N,), inlier count)."""
    p0 = np.ascontiguousarray(p0n, np.float64)
    p1 = np.ascontiguousarray(p1n, np.float64)
    R = np.zeros(9, np.float64)
    t = np.zeros(3, np.float64)
    inliers = np.zeros(len(p0), np.uint8)
    num = get_lib().ransac_essential_cpp(_dp(p0), _dp(p1), len(p0), float(th), int(max_iters),
                                         int(seed), _dp(R), _dp(t), inliers.ctypes.data_as(_U8P))
    return R.reshape(3, 3), t, inliers.astype(bool), int(num)
