"""Epipolar geometry: essential and fundamental matrices, epipolar
distances, pose errors (counterpart of `gluefactory_tpu/geometry/epipolar.py`).
Batched over leading dimensions, on the inputs' device.
"""

from __future__ import annotations

import torch

from .utils import skew_symmetric, to_homogeneous
from .wrappers import Camera, Pose


def T_to_E(T: Pose) -> torch.Tensor:
    """Essential matrix of a relative pose: E = [t]x R."""
    return skew_symmetric(T.t) @ T.R


def T_to_F(cam0: Camera, cam1: Camera, T_0to1: Pose) -> torch.Tensor:
    """Fundamental matrix of a calibrated relative pose."""
    K0_inv = torch.linalg.inv_ex(cam0.calibration_matrix()).inverse
    K1_inv = torch.linalg.inv_ex(cam1.calibration_matrix()).inverse
    return K1_inv.transpose(-1, -2) @ T_to_E(T_0to1) @ K0_inv


def sym_epipolar_distance(p0, p1, E, squared: bool = True) -> torch.Tensor:
    """Symmetric epipolar distance of aligned correspondences (..., N) in
    normalized coordinates: squared, the squared residual times the sum of
    the two lines' reciprocal squared norms; else the mean of the two
    point-to-line distances."""
    p0h = to_homogeneous(p0)
    p1h = to_homogeneous(p1)
    Ep0 = torch.einsum("...ij,...nj->...ni", E, p0h)
    Etp1 = torch.einsum("...ji,...nj->...ni", E, p1h)
    p1Ep0 = torch.einsum("...ni,...ni->...n", p1h, Ep0)
    d0 = torch.clamp(Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2, min=1e-6)
    d1 = torch.clamp(Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2, min=1e-6)
    if squared:
        return p1Ep0**2 * (1.0 / d0 + 1.0 / d1)
    return torch.abs(p1Ep0) * (1.0 / torch.sqrt(d0) + 1.0 / torch.sqrt(d1)) / 2.0


def sym_epipolar_distance_all(p0, p1, E, eps: float = 1e-15) -> torch.Tensor:
    """All-pairs symmetric epipolar distance (..., N0, N1): the mean of the
    two point-to-line distances, not squared."""
    p0h = to_homogeneous(p0)
    p1h = to_homogeneous(p1)
    Ep0 = torch.einsum("...ij,...nj->...ni", E, p0h)
    Etp1 = torch.einsum("...ji,...nj->...ni", E, p1h)
    p1Ep0 = torch.abs(torch.einsum("...mi,...ni->...nm", p1h, Ep0))
    d0 = torch.sqrt(Ep0[..., :, None, 0] ** 2 + Ep0[..., :, None, 1] ** 2 + eps)
    d1 = torch.sqrt(Etp1[..., None, :, 0] ** 2 + Etp1[..., None, :, 1] ** 2 + eps)
    return (p1Ep0 / d0 + p1Ep0 / d1) / 2.0


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def E_to_Rt_candidates(E: torch.Tensor):
    """The 4 (R, t) candidates of an essential matrix."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def angle_error_mat(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    cos = ((R1.transpose(-1, -2) @ R2).diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.rad2deg(torch.abs(torch.arccos(torch.clamp(cos, -1.0, 1.0))))


def angle_error_vec(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1)
    cos = (v1 * v2).sum(-1) / (n + eps)
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))


def relative_pose_error(T_0to1: Pose, R: torch.Tensor, t: torch.Tensor,
                        ignore_gt_t_thr: float = 0.0):
    """Angular translation and rotation errors against the GT pose, returned
    as (t_err, r_err); the translation error is up to sign, and 0 where the
    GT translation is shorter than `ignore_gt_t_thr`."""
    t_err = angle_error_vec(t, T_0to1.t)
    t_err = torch.minimum(t_err, 180.0 - t_err)
    t_norm = torch.linalg.vector_norm(T_0to1.t, dim=-1)
    t_err = torch.where(t_norm < ignore_gt_t_thr, torch.zeros_like(t_err), t_err)
    return t_err, angle_error_mat(R, T_0to1.R)
