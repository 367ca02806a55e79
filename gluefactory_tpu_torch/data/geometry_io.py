"""Cameras and poses as plain arrays for the loader's workers (counterpart of
`gluefactory_tpu/data/geometry_io.py`).

Datasets emit `camera` as a dict of numpy arrays (size, f, c, dist) and
poses as 4 x 4 matrices; `base_dataset.prepare_batch` turns them into
`Camera` and `Pose` on the batch's device.
"""

from __future__ import annotations

import numpy as np


def camera_dict_from_colmap(model: str, width: int, height: int, params) -> dict:
    """A COLMAP camera as a plain dict (as `Camera.from_colmap` reads it)."""
    params = np.asarray(params, dtype=np.float32)
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        fx = fy = params[0]
        cx, cy = params[1:3]
        dist = params[3:]
    elif model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV"):
        fx, fy, cx, cy = params[:4]
        dist = params[4:]
    else:
        raise ValueError(f"unsupported COLMAP model {model}")
    return {
        "size": np.array([width, height], np.float32),
        "f": np.array([fx, fy], np.float32),
        "c": np.array([cx, cy], np.float32),
        "dist": np.asarray(dist, np.float32),
    }


def camera_dict_from_K(K: np.ndarray, width=None, height=None) -> dict:
    """A pinhole camera from its calibration matrix; without a size, twice
    the principal point."""
    K = np.asarray(K, np.float32)
    if width is None:
        width, height = K[0, 2] * 2, K[1, 2] * 2
    return {
        "size": np.array([width, height], np.float32),
        "f": np.array([K[0, 0], K[1, 1]], np.float32),
        "c": np.array([K[0, 2], K[1, 2]], np.float32),
        "dist": np.zeros(0, np.float32),
    }


def scale_camera_dict(cam: dict, scales) -> dict:
    s = np.asarray(scales, np.float32)
    return {"size": cam["size"] * s, "f": cam["f"] * s, "c": cam["c"] * s, "dist": cam["dist"]}


def pose_matrix_from_Rt(R, t) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(R, np.float32)
    T[:3, 3] = np.asarray(t, np.float32).ravel()
    return T


def compose_pose(T_a: np.ndarray, T_b: np.ndarray) -> np.ndarray:
    """T_a @ T_b, in float64, rounded to float32."""
    return (np.asarray(T_a, np.float64) @ np.asarray(T_b, np.float64)).astype(np.float32)


def invert_pose(T: np.ndarray) -> np.ndarray:
    """The inverse of a rigid 4 x 4 pose, in float64, rounded to float32."""
    R = np.asarray(T, np.float64)[:3, :3]
    t = np.asarray(T, np.float64)[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out.astype(np.float32)
