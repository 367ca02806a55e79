"""Batched homography RANSAC on the device of its inputs (counterpart of
`gluefactory_tpu/ops/ransac.py`, homography part).

All hypotheses are drawn, fitted and scored at once: `n_iters` minimal sets
of 4 by a Gumbel top-k over the valid points, a 4-point DLT each
(`geometry.homography.compute_homography_dlt`, batched), every point's
symmetric transfer error under every hypothesis, the hypothesis with the
most inliers (non-finite ones never win), then two weighted-DLT refits on
its inliers, each kept only if finite and fitted on at least 4 points.

The Gumbel noise is JAX's (`utils/threefry.py`), so a seed gives the same
minimal sets as `jax.random.key(seed)` gives the JAX package. Inverses go
through `inv_ex`, which does not check for errors: a singular hypothesis
yields non-finite residuals, which are never inliers, as in JAX, and the
device is not waited for.
"""

from __future__ import annotations

import torch

from ..geometry.homography import compute_homography_dlt
from ..utils import threefry


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
