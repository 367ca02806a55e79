"""Camera and pose updates for dataset augmentation (counterpart of
`gluefactory_tpu/data/utils.py`): intrinsics and pose under 90-degree image
rotations and resizing, on the host in numpy.

The JAX package's deliberate divergence from upstream glue-factory is kept
(pinned there by `tests/test_megadepth.py::test_rotate_intrinsics_pose_projective_exact`,
here by `tests/test_torch_megadepth.py`):

- Upstream's own call site passes a (C, H, W) tensor shape into its
  `rotate_intrinsics`, whose `[:2]` slice then reads (channels, height) as
  (h, w); this module re-derives the update instead of matching that.
- Under the COLMAP continuous-pixel convention (pixel (i, j) centred at
  (j + 0.5, i + 0.5), the image spanning [0, w] x [0, h]), the
  principal-point flip is `w - cx` / `h - cy`, not the array-index form
  `w - 1 - cx` upstream uses: flipping the continuous interval [0, w] maps
  x to w - x.
- `rot` counts 90-degree clockwise (display-wise) image rotations, i.e. the
  image was rotated with `np.rot90(img, k=-rot)`; `image_shape` is the
  pre-rotation (h, w). The companion pose update applies Rz(rot * 90deg) in
  the camera frame so that K' @ [R'|t'] projects every world point onto the
  rotated pixel grid exactly.
"""

from __future__ import annotations

import numpy as np


def scale_intrinsics(K: np.ndarray, scales) -> np.ndarray:
    """Scale a 3x3 intrinsics matrix for image resizing by (sx, sy)."""
    scales = np.diag([scales[0], scales[1], 1.0])
    return (scales @ K).astype(np.float32)


def rotate_intrinsics(K: np.ndarray, image_shape, rot: int) -> np.ndarray:
    """Update intrinsics for `rot` 90-degree clockwise image rotations
    (`np.rot90(img, k=-rot)`) of an image of PRE-rotation shape (h, w[, c]).

    Continuous-coordinate pixel maps (see module docstring for derivation):
      rot=1 (cw):  (x', y') = (h - y, x)
      rot=2:       (x', y') = (w - x, h - y)
      rot=3 (ccw): (x', y') = (y, w - x)
    """
    h, w = image_shape[0], image_shape[1]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    rot = rot % 4
    if rot == 1:
        return np.array(
            [[fy, 0.0, h - cy], [0.0, fx, cx], [0.0, 0.0, 1.0]], dtype=np.float32
        )
    if rot == 2:
        return np.array(
            [[fx, 0.0, w - cx], [0.0, fy, h - cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )
    if rot == 3:
        return np.array(
            [[fy, 0.0, cy], [0.0, fx, w - cx], [0.0, 0.0, 1.0]], dtype=np.float32
        )
    return K.astype(np.float32)


def rotate_pose_inplane(T_w2cam: np.ndarray, rot: int) -> np.ndarray:
    """Apply the in-plane camera rotation matching `rot` 90-degree clockwise
    image rotations to a 4x4 world-to-camera pose: p' = Rz(rot * 90deg) p,
    so (x', y') = (h - y, x) at rot=1 comes out of K' @ p' exactly."""
    rot = rot % 4
    ang = np.deg2rad(90.0 * rot)
    R_inplane = np.array(
        [
            [np.cos(ang), -np.sin(ang), 0.0, 0.0],
            [np.sin(ang), np.cos(ang), 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
    return (R_inplane @ np.asarray(T_w2cam, np.float32)).astype(np.float32)
