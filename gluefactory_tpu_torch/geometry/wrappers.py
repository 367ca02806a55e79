"""Batched SE(3) `Pose` and pinhole `Camera` (counterpart of
`gluefactory_tpu/geometry/wrappers.py`): plain classes over tensors with
batch dimensions, each method computed on its tensors' device. `.to(device)`
moves one (the relative-pose estimator moves the cameras to the card).

Conventions:
  - `Pose` maps points FROM world / frame a TO the camera / frame b:
    p_b = R p_a + t.
  - `Camera` follows COLMAP: pixel (0.5, 0.5) is the centre of the top-left
    pixel; `cam2image` = denormalize(distort(project(p_cam))).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .utils import distort_points, so3exp_map, to_homogeneous, undistort_points


def _tensor(x, dtype=None, device=None) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=dtype, device=device)


class Pose:
    """Batched SE(3) transform storing R (..., 3, 3) and t (..., 3)."""

    def __init__(self, R, t):
        self.R = _tensor(R)
        self.t = _tensor(t)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_Rt(cls, R, t) -> "Pose":
        return cls(R, t)

    @classmethod
    def from_aa(cls, aa, t) -> "Pose":
        return cls(so3exp_map(_tensor(aa)), t)

    @classmethod
    def from_4x4mat(cls, T) -> "Pose":
        """R and t as contiguous copies, as JAX's slices are (numpy's dot
        of a strided vector sums in another order than of a dense one)."""
        T = _tensor(T)
        return cls(T[..., :3, :3].contiguous(), T[..., :3, 3].contiguous())

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3))
        return cls(R, torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device))

    @classmethod
    def from_colmap(cls, image) -> "Pose":
        return cls.from_4x4mat(np.asarray(image.cam_from_world.matrix()))

    @classmethod
    def stack(cls, poses: Sequence["Pose"], dim: int = 0) -> "Pose":
        return cls(torch.stack([p.R for p in poses], dim=dim),
                   torch.stack([p.t for p in poses], dim=dim))

    @classmethod
    def concatenate(cls, poses: Sequence["Pose"], dim: int = 0) -> "Pose":
        return cls(torch.cat([p.R for p in poses], dim=dim),
                   torch.cat([p.t for p in poses], dim=dim))

    # -- tensors ----------------------------------------------------------
    def map_tensors(self, func) -> "Pose":
        """`func` applied to R and t."""
        return Pose(func(self.R), func(self.t))

    def to(self, *args, **kwargs) -> "Pose":
        return self.map_tensors(lambda x: x.to(*args, **kwargs))

    @property
    def shape(self):
        return self.t.shape[:-1]

    @property
    def dtype(self):
        return self.t.dtype

    @property
    def device(self):
        return self.t.device

    def __getitem__(self, idx) -> "Pose":
        return Pose(self.R[idx], self.t[idx])

    def astype(self, dtype) -> "Pose":
        return self.to(dtype)

    # -- core ops ---------------------------------------------------------
    def inv(self) -> "Pose":
        R_inv = self.R.transpose(-1, -2)
        return Pose(R_inv, -torch.einsum("...ij,...j->...i", R_inv, self.t))

    def compose(self, other: "Pose") -> "Pose":
        """self @ other: apply `other` first, then `self`."""
        return Pose(self.R @ other.R, torch.einsum("...ij,...j->...i", self.R, other.t) + self.t)

    def __matmul__(self, other):
        if isinstance(other, Pose):
            return self.compose(other)
        return self.transform(other)

    def transform(self, p3d: torch.Tensor) -> torch.Tensor:
        """Transform (..., N, 3) points."""
        return torch.einsum("...ij,...nj->...ni", self.R, p3d) + self.t[..., None, :]

    def magnitude(self):
        """(rotation angle in degrees, translation norm)."""
        trace = self.R.diagonal(dim1=-2, dim2=-1).sum(-1)
        cos = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
        return torch.rad2deg(torch.abs(torch.arccos(cos))), torch.linalg.vector_norm(self.t, dim=-1)

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        Rt = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros_like(Rt[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([Rt, bottom], dim=-2)

    def __repr__(self):
        return f"Pose(shape={tuple(self.shape)}, dtype={self.dtype})"


class Camera:
    """Batched pinhole camera with radial distortion. Holds size (..., 2)
    [w, h], f (..., 2), c (..., 2) and dist (..., D)."""

    def __init__(self, size, f, c, dist=None):
        self.size = _tensor(size)
        self.f = _tensor(f)
        self.c = _tensor(c)
        if dist is None:
            dist = torch.zeros(self.f.shape[:-1] + (0,), dtype=self.f.dtype, device=self.f.device)
        self.dist = _tensor(dist)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_calibration_matrix(cls, K, size=None) -> "Camera":
        K = _tensor(K)
        f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
        c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
        if size is None:
            size = torch.ceil(c * 2.0)
        return cls(size, f, c)

    @classmethod
    def from_colmap(cls, camera: dict) -> "Camera":
        """From a COLMAP camera dict {model, width, height, params}."""
        model = camera["model"]
        params = np.asarray(camera["params"], dtype=np.float64)
        w, h = camera["width"], camera["height"]
        if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            fx = fy = params[0]
            cx, cy = params[1:3]
            dist = params[3:]
        elif model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV"):
            fx, fy, cx, cy = params[:4]
            dist = params[4:]
        else:
            raise ValueError(f"unsupported COLMAP model {model}")
        f32 = torch.float32
        return cls(torch.tensor([w, h], dtype=f32), torch.tensor([fx, fy], dtype=f32),
                   torch.tensor([cx, cy], dtype=f32), torch.tensor(dist, dtype=f32))

    @classmethod
    def stack(cls, cams: Sequence["Camera"], dim: int = 0) -> "Camera":
        return cls(*(torch.stack([getattr(x, k) for x in cams], dim=dim)
                     for k in ("size", "f", "c", "dist")))

    @classmethod
    def concatenate(cls, cams: Sequence["Camera"], dim: int = 0) -> "Camera":
        return cls(*(torch.cat([getattr(x, k) for x in cams], dim=dim)
                     for k in ("size", "f", "c", "dist")))

    # -- tensors ----------------------------------------------------------
    def map_tensors(self, func) -> "Camera":
        """`func` applied to size, f, c and dist."""
        return Camera(func(self.size), func(self.f), func(self.c), func(self.dist))

    def to(self, *args, **kwargs) -> "Camera":
        return self.map_tensors(lambda x: x.to(*args, **kwargs))

    @property
    def shape(self):
        return self.f.shape[:-1]

    @property
    def dtype(self):
        return self.f.dtype

    @property
    def device(self):
        return self.f.device

    def __getitem__(self, idx) -> "Camera":
        return Camera(self.size[idx], self.f[idx], self.c[idx], self.dist[idx])

    def astype(self, dtype) -> "Camera":
        return self.to(dtype)

    # -- geometry ---------------------------------------------------------
    def scale(self, scales) -> "Camera":
        """Rescale for an image resize; `scales` is a scalar or (..., 2)."""
        s = _tensor(scales, dtype=self.f.dtype, device=self.f.device).expand(self.f.shape)
        return Camera(self.size * s, self.f * s, self.c * s, self.dist)

    def crop(self, left_top, new_size) -> "Camera":
        lt = _tensor(left_top, dtype=self.c.dtype, device=self.c.device)
        size = _tensor(new_size, dtype=self.size.dtype, device=self.size.device)
        return Camera(size, self.f, self.c - lt, self.dist)

    def project(self, p3d: torch.Tensor):
        """(..., N, 3) camera-frame points -> normalized 2D and validity
        (depth above 1e-3)."""
        z = p3d[..., -1]
        valid = z > 1e-3
        z_safe = torch.where(valid, z, torch.ones_like(z))
        return p3d[..., :-1] / z_safe[..., None], valid

    def distort(self, p2d: torch.Tensor):
        if self.dist.shape[-1] == 0:
            return p2d, torch.ones(p2d.shape[:-1], dtype=torch.bool, device=p2d.device)
        return distort_points(p2d, self.dist[..., None, :])

    def undistort(self, p2d: torch.Tensor):
        valid = torch.ones(p2d.shape[:-1], dtype=torch.bool, device=p2d.device)
        if self.dist.shape[-1] == 0:
            return p2d, valid
        return undistort_points(p2d, self.dist[..., None, :]), valid

    def denormalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return p2d * self.f[..., None, :] + self.c[..., None, :]

    def normalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return (p2d - self.c[..., None, :]) / self.f[..., None, :]

    def in_image(self, p2d: torch.Tensor) -> torch.Tensor:
        """Whether pixel points fall inside [0, size - 1]."""
        size = self.size[..., None, :]
        return ((p2d >= 0) & (p2d <= size - 1)).all(dim=-1)

    def cam2image(self, p3d: torch.Tensor):
        """(..., N, 3) camera-frame points -> pixel coordinates and validity."""
        p2d, visible = self.project(p3d)
        p2d, mask = self.distort(p2d)
        p2d = self.denormalize(p2d)
        return p2d, visible & mask & self.in_image(p2d)

    def image2cam(self, p2d: torch.Tensor) -> torch.Tensor:
        """Pixel coordinates -> unit-depth rays (..., N, 3)."""
        p2d, _ = self.undistort(self.normalize(p2d))
        return to_homogeneous(p2d)

    def calibration_matrix(self) -> torch.Tensor:
        K = torch.zeros(self.shape + (3, 3), dtype=self.dtype, device=self.device)
        K[..., 0, 0] = self.f[..., 0]
        K[..., 1, 1] = self.f[..., 1]
        K[..., 0, 2] = self.c[..., 0]
        K[..., 1, 2] = self.c[..., 1]
        K[..., 2, 2] = 1.0
        return K

    def to_cameradict(self) -> dict:
        size = self.size.detach().cpu().numpy()
        return {
            "model": "PINHOLE" if self.dist.shape[-1] == 0 else "OPENCV",
            "width": int(size[..., 0]),
            "height": int(size[..., 1]),
            "params": torch.cat([self.f, self.c, self.dist], dim=-1).tolist(),
        }

    def __repr__(self):
        return f"Camera(shape={tuple(self.shape)}, dist={self.dist.shape[-1]}, dtype={self.dtype})"


def unproject_depth(camera: Camera, p2d: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Lift pixel points with depths to camera-frame 3D points."""
    return camera.image2cam(p2d) * depth[..., None]
