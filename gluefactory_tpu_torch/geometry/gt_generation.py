"""Ground-truth correspondences from a known homography (counterpart of the
homography part of `gluefactory_tpu/geometry/gt_generation.py`). Batched,
static shapes, on the device inside the train step.

Match conventions: `matches0[i]` is the index of the keypoint of image 1
matched to keypoint i of image 0; UNMATCHED (-1) is a certain negative,
IGNORE (-2) is left out of the loss.
"""

from __future__ import annotations

import torch

from .depth import project, sample_depth
from .epipolar import T_to_F, sym_epipolar_distance_all
from .homography import warp_points
from .wrappers import Camera, Pose

IGNORE = -2
UNMATCHED = -1


def _assignment_from_dists(dist_sq, pos_th_sq: float, negative0, negative1, ignore0=None,
                           ignore1=None) -> dict:
    """Mutual-nearest assignment: positives are mutual row / column minima of
    the squared distance matrix below `pos_th_sq`; labels are positive ->
    argmin, `negativeX` -> UNMATCHED, everything else IGNORE, `ignoreX`
    forced to IGNORE. `argmin` takes the first of equal minima, as
    `jnp.argmin` does, an all-inf row included (index 0)."""
    B, M, N = dist_sq.shape
    dev = dist_sq.device
    min0 = dist_sq.amin(dim=-1)
    min1 = dist_sq.amin(dim=-2)
    # torch's argmin is not documented to take the first of ties
    argmin0 = _first_index(dist_sq == min0[..., None], dim=-1)
    argmin1 = _first_index(dist_sq == min1[..., None, :], dim=-2)
    inv0 = torch.gather(argmin1, 1, argmin0)
    inv1 = torch.gather(argmin0, 1, argmin1)
    mutual0 = inv0 == torch.arange(M, device=dev)[None]
    mutual1 = inv1 == torch.arange(N, device=dev)[None]

    positive0 = mutual0 & (min0 < pos_th_sq)
    positive1 = mutual1 & (min1 < pos_th_sq)
    if ignore0 is not None:
        positive0 = positive0 & ~ignore0
        negative0 = negative0 & ~ignore0
    if ignore1 is not None:
        positive1 = positive1 & ~ignore1
        negative1 = negative1 & ~ignore1

    unmatched = torch.tensor(UNMATCHED, device=dev)
    ignore = torch.tensor(IGNORE, device=dev)
    matches0 = torch.where(positive0, argmin0, torch.where(negative0, unmatched, ignore))
    matches1 = torch.where(positive1, argmin1, torch.where(negative1, unmatched, ignore))
    assignment = (positive0[..., :, None] & positive1[..., None, :]
                  & (argmin0[..., :, None] == torch.arange(N, device=dev)[None, None, :]))
    return {"assignment": assignment, "matches0": matches0.to(torch.int32),
            "matches1": matches1.to(torch.int32)}


def _first_index(hits: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along `dim` (0 where there is none). A row
    of inf distances is all True against its inf minimum, so it gives 0."""
    n = hits.shape[dim]
    shape = [1] * hits.dim()
    shape[dim] = n
    idx = torch.arange(n, device=hits.device).view(shape)
    return torch.where(hits, idx, n).amin(dim=dim).clamp(max=n - 1)


def gt_matches_from_homography(kp0, kp1, H, pos_th: float = 3.0, neg_th: float = 6.0,
                               mask0=None, mask1=None) -> dict:
    """GT matches of homography-related views: kp0 (B, M, 2), kp1 (B, N, 2),
    H (B, 3, 3). Positives from the larger of the forward and backward
    squared reprojection distances, negatives from each one-directional
    matrix. `maskX` (B, M / N) bool marks real slots: a padding slot is never
    a positive and is labelled IGNORE."""
    kp0_1 = warp_points(kp0, H)
    kp1_0 = warp_points(kp1, H, inverse=True)
    dist0 = ((kp0_1[..., :, None, :] - kp1[..., None, :, :]) ** 2).sum(-1)
    dist1 = ((kp0[..., :, None, :] - kp1_0[..., None, :, :]) ** 2).sum(-1)
    dist0, dist1 = _mask_rows_cols((dist0, dist1), mask0, mask1)
    dist = torch.maximum(dist0, dist1)
    negative0 = dist0.amin(dim=-1) > neg_th**2
    negative1 = dist1.amin(dim=-2) > neg_th**2
    return _assignment_from_dists(dist, pos_th**2, negative0, negative1,
                                  ignore0=None if mask0 is None else ~mask0,
                                  ignore1=None if mask1 is None else ~mask1)


def _mask_rows_cols(dists, mask0, mask1):
    """Padding rows (mask0 False) and columns (mask1 False) set to inf."""
    inf = torch.tensor(float("inf"), dtype=dists[0].dtype, device=dists[0].device)
    out = []
    for d in dists:
        if mask0 is not None:
            d = torch.where(mask0[..., :, None], d, inf)
        if mask1 is not None:
            d = torch.where(mask1[..., None, :], d, inf)
        out.append(d)
    return out


def gt_matches_from_pose_depth(kp0, kp1, camera0: Camera, camera1: Camera, T_0to1: Pose, depth0,
                               depth1, pos_th: float = 3.0, neg_th: float = 5.0,
                               epi_th: float | None = None, ccth: float | None = None,
                               mask0=None, mask1=None) -> dict:
    """GT matches from a relative pose and depth maps: kp0 (B, M, 2), kp1
    (B, N, 2), depth0 / depth1 (B, H, W). Each keypoint set, lifted by its
    sampled depth, is projected into the other view; positives are mutual
    minima of the larger squared reprojection distance between pairs that
    are both visible, negatives come from each one-directional matrix among
    points with valid depth. With `epi_th` (the rescue is gated by it, its
    threshold is `neg_th`, as in the JAX package), a point without valid
    depth that lies farther than `neg_th` px from every still-uncertain
    point's epipolar line becomes a negative. `maskX` (B, M / N) marks real
    slots: a padding slot is never positive and is labelled IGNORE. Also
    returns `visible0` / `visible1`."""
    d0, valid0 = sample_depth(kp0, depth0)
    d1, valid1 = sample_depth(kp1, depth1)
    if mask0 is not None:
        valid0 = valid0 & mask0
    if mask1 is not None:
        valid1 = valid1 & mask1
    kp0_1, vis0 = project(kp0, d0, depth1, camera0, camera1, T_0to1, valid0, ccth=ccth)
    kp1_0, vis1 = project(kp1, d1, depth0, camera1, camera0, T_0to1.inv(), valid1, ccth=ccth)
    dist0 = ((kp0_1[..., :, None, :] - kp1[..., None, :, :]) ** 2).sum(-1)
    dist1 = ((kp0[..., :, None, :] - kp1_0[..., None, :, :]) ** 2).sum(-1)
    dist0, dist1 = _mask_rows_cols((dist0, dist1), mask0, mask1)
    inf = torch.tensor(float("inf"), dtype=dist0.dtype, device=dist0.device)
    visible = vis0[..., :, None] & vis1[..., None, :]
    dist = torch.where(visible, torch.maximum(dist0, dist1), inf)
    negative0 = (dist0.amin(dim=-1) > neg_th**2) & valid0
    negative1 = (dist1.amin(dim=-2) > neg_th**2) & valid1
    out = _assignment_from_dists(dist, pos_th**2, negative0, negative1,
                                 ignore0=None if mask0 is None else ~mask0,
                                 ignore1=None if mask1 is None else ~mask1)
    if epi_th is not None:
        epi_dist = sym_epipolar_distance_all(kp0, kp1, T_to_F(camera0, camera1, T_0to1))
        m0, m1 = out["matches0"], out["matches1"]
        uncertain = (m0[..., :, None] == IGNORE) & (m1[..., None, :] == IGNORE)
        epi_dist = torch.where(uncertain, epi_dist, inf)
        new0 = ~valid0 & (epi_dist.amin(dim=-1) > neg_th)
        new1 = ~valid1 & (epi_dist.amin(dim=-2) > neg_th)
        if mask0 is not None:
            new0 = new0 & mask0
        if mask1 is not None:
            new1 = new1 & mask1
        unmatched = torch.tensor(UNMATCHED, dtype=torch.int32, device=m0.device)
        out["matches0"] = torch.where(new0, unmatched, m0)
        out["matches1"] = torch.where(new1, unmatched, m1)
    out["visible0"] = vis0
    out["visible1"] = vis1
    return out


def gt_from_matches0(matches0: torch.Tensor, n1: int) -> torch.Tensor:
    """Expand matches0 (B, M) into a bool assignment matrix (B, M, n1)."""
    cols = torch.arange(n1, device=matches0.device)[None, None, :]
    return (matches0[..., None] == cols) & (matches0[..., None] >= 0)
