"""Batched homography, point and line homography, and essential-matrix
RANSAC on the device of their inputs (counterpart of
`gluefactory_tpu/ops/ransac.py`).

All hypotheses are drawn, fitted and scored at once: `n_iters` minimal sets
by a Gumbel top-k over the valid points, a minimal fit each, every point's
residual under every hypothesis, the hypothesis with the most inliers
(non-finite ones never win), then two weighted least-squares refits on its
inliers. Homography: 4-point DLT (`geometry.homography.
compute_homography_dlt`, batched), symmetric transfer error, each refit
kept if finite and fitted on at least 4 points. Essential matrix
(normalized coordinates): the 5-point solver (`ops/essential5.py`, up to 10
candidates a set) or the 8-point one, the squared symmetric epipolar
distance, weighted 8-point refits kept only where they do not lose
consensus, then the (R, t) of the four decompositions with the most inliers
in front of both cameras.

The Gumbel noise is JAX's (`utils/threefry.py`), so a seed gives the same
minimal sets as `jax.random.key(seed)` gives the JAX package. Inverses go
through `inv_ex`, which does not check for errors: a singular hypothesis
yields non-finite residuals, which are never inliers, as in JAX, and the
device is not waited for.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.homography import compute_homography_dlt
from ..geometry.utils import to_homogeneous
from ..utils import threefry
from .essential5 import essential_5pt


def sample_minimal_sets(seed: int, n_iters: int, sample_size: int, valid: torch.Tensor):
    """(n_iters, sample_size) indices of valid entries: a Gumbel top-k per
    row, without replacement within a set."""
    g = threefry.gumbel(seed, (n_iters, valid.shape[0]), device=valid.device)
    logits = torch.where(valid, 0.0, float("-inf"))[None, :]
    return torch.topk(logits + g, sample_size, dim=-1).indices


def _warp(points: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """(N, 2) points by (..., 3, 3) homographies -> (..., N, 2)."""
    pts_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    warped = torch.einsum("...ij,nj->...ni", H, pts_h)
    return warped[..., :-1] / (warped[..., -1:] + 1e-8)


def homography_residuals(H: torch.Tensor, pts0: torch.Tensor, pts1: torch.Tensor) -> torch.Tensor:
    """Symmetric squared transfer error of every point under each of the
    (..., 3, 3) homographies: (..., N)."""
    fwd = _warp(pts0, H)
    bwd = _warp(pts1, torch.linalg.inv_ex(H).inverse)
    e0 = ((fwd - pts1) ** 2).sum(-1)
    e1 = ((bwd - pts0) ** 2).sum(-1)
    return 0.5 * (e0 + e1)


def ransac_homography(pts0: torch.Tensor, pts1: torch.Tensor, valid: torch.Tensor, th: float,
                      seed: int = 0, n_iters: int = 1024) -> dict:
    """pts0 / pts1 (N, 2), valid (N,) bool, all on one device. Returns
    M_0to1 (3, 3), inliers (N,), num_inliers and success (num_inliers >= 4),
    all tensors on that device."""
    idx = sample_minimal_sets(seed, n_iters, 4, valid)
    H_hyp = compute_homography_dlt(pts0[idx], pts1[idx])
    th2 = th * th
    inl = (homography_residuals(H_hyp, pts0, pts1) < th2) & valid[None, :]
    finite = torch.isfinite(H_hyp).all(dim=-1).all(dim=-1)
    counts = torch.where(finite, inl.sum(-1), -1)
    H = H_hyp[torch.argmax(counts)]
    for _ in range(2):  # local optimisation: weighted DLT refits on the inliers
        w = ((homography_residuals(H, pts0, pts1) < th2) & valid).float()
        H_new = compute_homography_dlt(pts0[None], pts1[None], w[None])[0]
        ok = torch.isfinite(H_new).all() & (w.sum() >= 4)
        H = torch.where(ok, H_new, H)
    inliers = (homography_residuals(H, pts0, pts1) < th2) & valid
    num = inliers.sum()
    return {"M_0to1": H, "inliers": inliers, "num_inliers": num, "success": num >= 4}


def _line_residuals(H: torch.Tensor, lines0: torch.Tensor, lines1: torch.Tensor) -> torch.Tensor:
    """Matched segments (L, 2, 2) under each of the (..., 3, 3) homographies:
    the larger distance of the two warped endpoints to the line through the
    matched segment, averaged over both directions: (..., L)."""

    def perp_dist(endpoints, target):
        p0, p1 = target[:, 0], target[:, 1]
        d = p1 - p0
        n = torch.stack([-d[:, 1], d[:, 0]], dim=-1)
        n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-8)
        off = endpoints - p0[:, None, :]
        return (off * n[:, None, :]).sum(-1).abs().max(-1).values

    L = lines0.shape[0]
    ep0_w = _warp(lines0.reshape(-1, 2), H).reshape(H.shape[:-2] + (L, 2, 2))
    ep1_w = _warp(lines1.reshape(-1, 2), torch.linalg.inv_ex(H).inverse)
    ep1_w = ep1_w.reshape(H.shape[:-2] + (L, 2, 2))
    return 0.5 * (perp_dist(ep0_w, lines1) + perp_dist(ep1_w, lines0))


def ransac_homography_hybrid(pts0, pts1, pt_valid, lines0, lines1, ln_valid, th: float,
                             seed: int = 0, n_iters: int = 1024) -> dict:
    """Point and line homography RANSAC: 4-point hypotheses (the same minimal
    sets as `ransac_homography`), each scored by its point inliers (squared
    symmetric transfer error under th^2) plus its line inliers (line
    residual under th), then two weighted DLT refits on the point inliers.
    pts (N, 2) with pt_valid (N,), lines (L, 2, 2) with ln_valid (L,).
    Returns M_0to1, inliers, line_inliers, num_inliers and success (at least
    4 point or 4 line inliers), tensors on the inputs' device."""
    idx = sample_minimal_sets(seed, n_iters, 4, pt_valid)
    H_hyp = compute_homography_dlt(pts0[idx], pts1[idx])
    th2 = th * th
    p_inl = (homography_residuals(H_hyp, pts0, pts1) < th2) & pt_valid[None, :]
    l_inl = (_line_residuals(H_hyp, lines0, lines1) < th) & ln_valid[None, :]
    finite = torch.isfinite(H_hyp).all(dim=-1).all(dim=-1)
    counts = torch.where(finite, p_inl.sum(-1) + l_inl.sum(-1), -1)
    H = H_hyp[torch.argmax(counts)]
    for _ in range(2):
        w = ((homography_residuals(H, pts0, pts1) < th2) & pt_valid).float()
        H_new = compute_homography_dlt(pts0[None], pts1[None], w[None])[0]
        ok = torch.isfinite(H_new).all() & (w.sum() >= 4)
        H = torch.where(ok, H_new, H)
    p_inl = (homography_residuals(H, pts0, pts1) < th2) & pt_valid
    l_inl = (_line_residuals(H, lines0, lines1) < th) & ln_valid
    return {"M_0to1": H, "inliers": p_inl, "line_inliers": l_inl,
            "num_inliers": p_inl.sum() + l_inl.sum(),
            "success": (p_inl.sum() >= 4) | (l_inl.sum() >= 4)}


def _squared_threshold(th: float) -> float:
    """th^2 as the JAX package forms it inside its jitted function: th
    rounded to float32, then squared in float32."""
    th32 = np.float32(th)
    return float(th32 * th32)


def _epipolar_rows(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """The rows (..., 9) of the epipolar constraint x1^T E x0 = 0."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)],
                       dim=-1)


def _to_essential(e: torch.Tensor) -> torch.Tensor:
    """(..., 9) -> the nearest (..., 3, 3) with singular values (1, 1, 0)."""
    U, _, Vh = torch.linalg.svd(e.reshape(e.shape[:-1] + (3, 3)))
    return (U[..., :, :2] @ Vh[..., :2, :])


def _essential_8pt(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """8-point essential matrices from (..., 8, 2) normalized points."""
    A = _epipolar_rows(p0, p1)
    return _to_essential(torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors[..., :, 0])


def _essential_8pt_weighted(p0, p1, w) -> torch.Tensor:
    """The weighted 8-point fit over all N points, weights w (N,)."""
    A = _epipolar_rows(p0, p1)
    return _to_essential(torch.linalg.eigh((A * w[:, None]).T @ A).eigenvectors[:, 0])


def _epipolar_residuals(E: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Squared symmetric epipolar distance of every point (N, 2) under each
    of the (..., 3, 3) matrices: (..., N)."""
    p0h, p1h = to_homogeneous(p0), to_homogeneous(p1)
    Ep0 = torch.einsum("...ij,nj->...ni", E, p0h)
    Etp1 = torch.einsum("...ji,nj->...ni", E, p1h)
    num = (p1h * Ep0).sum(-1) ** 2
    return num * (1.0 / (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + 1e-15)
                  + 1.0 / (Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2 + 1e-15))


def _triangulate_depths(R, t, p0, p1):
    """Depths (z0, z1) of each correspondence along its two rays, by least
    squares of z1 r1 = R (z0 r0) + t."""
    r0, r1 = to_homogeneous(p0), to_homogeneous(p1)
    Rr0 = r0 @ R.T
    a11 = (Rr0 * Rr0).sum(-1)
    a12 = -(Rr0 * r1).sum(-1)
    a22 = (r1 * r1).sum(-1)
    b1 = -(Rr0 * t).sum(-1)
    b2 = (r1 * t).sum(-1)
    det = a11 * a22 - a12 * a12
    return (b1 * a22 - b2 * a12) / (det + 1e-15), (a11 * b2 - a12 * b1) / (det + 1e-15)


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def ransac_essential(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor, th: float,
                     seed: int = 0, n_iters: int = 1024, solver: str = "5pt") -> dict:
    """Essential-matrix RANSAC over normalized coordinates: p0 / p1 (N, 2),
    valid (N,) bool, all on one device; `th` in normalized units. Minimal
    sets of 5 (`solver="5pt"`, up to 10 hypotheses each) or 8 (`"8pt"`).
    Returns E, R, t (cheirality resolved), inliers (N,), num_inliers and
    success (at least 5, or 8, inliers), all tensors on that device."""
    if solver == "5pt":
        idx = sample_minimal_sets(seed, n_iters, 5, valid)
        E_hyp = essential_5pt(p0[idx], p1[idx]).reshape(-1, 3, 3)
    elif solver == "8pt":
        idx = sample_minimal_sets(seed, n_iters, 8, valid)
        E_hyp = _essential_8pt(p0[idx], p1[idx])
    else:
        raise ValueError(f"unknown essential-matrix solver {solver!r}")
    finite = torch.isfinite(E_hyp).all(dim=-1).all(dim=-1)
    E_hyp = torch.where(finite[:, None, None], E_hyp, torch.zeros_like(E_hyp))
    th2 = _squared_threshold(th)
    inl = (_epipolar_residuals(E_hyp, p0, p1) < th2) & valid[None, :]
    counts = torch.where(finite, inl.sum(-1), -1)
    E = E_hyp[torch.argmax(counts)]
    for _ in range(2):  # local optimisation, kept where it does not lose consensus
        inliers = (_epipolar_residuals(E, p0, p1) < th2) & valid
        E_new = _essential_8pt_weighted(p0, p1, inliers.float())
        new_inl = (_epipolar_residuals(E_new, p0, p1) < th2) & valid
        ok = torch.isfinite(E_new).all() & (inliers.sum() >= 8) & (new_inl.sum() >= inliers.sum())
        E = torch.where(ok, E_new, E)
    inliers = (_epipolar_residuals(E, p0, p1) < th2) & valid

    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1, R2, t = U @ W @ Vh, U @ W.T @ Vh, U[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    scores = []
    for R_c, t_c in zip(Rs, ts):
        z0, z1 = _triangulate_depths(R_c, t_c, p0, p1)
        scores.append(((z0 > 0) & (z1 > 0) & inliers).sum())
    k = torch.argmax(torch.stack(scores))
    num = inliers.sum()
    return {"E": E, "R": Rs[k], "t": ts[k], "inliers": inliers, "num_inliers": num,
            "success": num >= (5 if solver == "5pt" else 8)}
