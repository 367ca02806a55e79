"""Ground-truth line matches (counterpart of `gluefactory_tpu/geometry/gt_lines.py`).

Points are sampled along each line, warped (homography) or projected (pose
and depth) into the other view, and counted where they fall within
`perp_dist_th` of a candidate segment with their foot inside it; the count
products are assigned by an auction (Bertsekas), the JAX package's
replacement for upstream's Hungarian solver, and the assigned pairs that
overlap enough both ways are the positives.

The auction runs on the device of its input. Its loop tests convergence on
the host only every `CHECK_EVERY` iterations: once no row bids, an iteration
changes nothing, so the extra iterations leave the result as the JAX
package's `lax.while_loop` leaves it, and the loop still stops at
`max_iters`. `auction_with_count` also returns the iterations in which some
row bid (the JAX loop's trip count).
"""

from __future__ import annotations

import torch

from .depth import project, sample_depth
from .homography import warp_points
from .wrappers import Camera, Pose

IGNORE = -2
UNMATCHED = -1
CHECK_EVERY = 16


def greedy_assignment(scores: torch.Tensor, min_score: float):
    """Batched greedy assignment: min(M, N) times take the global max of
    (B, M, N) (first index on ties), assign it if it reaches `min_score` and
    mask its row and column. Returns matches0 (B, M), matches1 (B, N)."""
    B, M, N = scores.shape
    s = scores.clone()
    m0 = torch.full((B, M), UNMATCHED, dtype=torch.long, device=scores.device)
    m1 = torch.full((B, N), UNMATCHED, dtype=torch.long, device=scores.device)
    rows = torch.arange(M, device=scores.device)[None]
    cols = torch.arange(N, device=scores.device)[None]
    for _ in range(min(M, N)):
        flat = s.reshape(B, M * N)
        idx = torch.argmax(flat, dim=-1)
        val = torch.gather(flat, 1, idx[:, None])[:, 0]
        i, j = idx // N, idx % N
        ok = val >= min_score
        m0 = torch.where(ok[:, None] & (rows == i[:, None]), j[:, None], m0)
        m1 = torch.where(ok[:, None] & (cols == j[:, None]), i[:, None], m1)
        hit = (rows == i[:, None])[:, :, None] | (cols == j[:, None])[:, None, :]
        s = torch.where(ok[:, None, None] & hit, float("-inf"), s)
    return m0, m1


def auction_assignment(scores: torch.Tensor, min_score: float, eps: float = 5e-3,
                       max_iters: int = 1000, outside_option: float = 0.0):
    """Batched auction maximising the total score of (B, M, N), -inf for
    forbidden pairs: Jacobi bidding while some unassigned row's best value
    reaches `outside_option`, ties to the first index; assigned pairs below
    `min_score` are dropped at the end. Returns matches0 (B, M), matches1
    (B, N), equal to the JAX package's."""
    return auction_with_count(scores, min_score, eps, max_iters, outside_option)[:2]


def auction_with_count(scores: torch.Tensor, min_score: float, eps: float = 5e-3,
                       max_iters: int = 1000, outside_option: float = 0.0):
    """`auction_assignment`'s matches0 and matches1, and the number of
    iterations in which some row bid."""
    B, M, N = scores.shape
    dev = scores.device
    lam = outside_option
    neg = float("-inf")
    rows = torch.arange(M, device=dev)
    cols = torch.arange(N, device=dev)
    prices = torch.zeros((B, N), dtype=scores.dtype, device=dev)
    assigned_col = torch.full((B, M), UNMATCHED, dtype=torch.long, device=dev)
    active = torch.zeros((), dtype=torch.long, device=dev)

    def wants(prices, assigned_col):
        best = (scores - prices[:, None, :]).max(-1).values
        return (assigned_col == UNMATCHED) & (best >= lam)

    it = 0
    while it < max_iters and bool(wants(prices, assigned_col).any()):
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            values = scores - prices[:, None, :]
            v1, j_star = values.max(-1).values, values.argmax(-1)
            one_hot = cols[None, None, :] == j_star[..., None]
            v2 = values.masked_fill(one_hot, neg).max(-1).values
            v2 = torch.where(torch.isfinite(v2), v2, torch.full_like(v2, lam))
            bidding = (assigned_col == UNMATCHED) & (v1 >= lam)
            active = active + bidding.any().long()
            bid = v1 - torch.clamp(v2, min=lam) + eps
            bid_matrix = torch.where(bidding[:, :, None] & one_hot, bid[:, :, None],
                                     torch.full_like(values, neg))
            top_bid, top_row = bid_matrix.max(1).values, bid_matrix.argmax(1)
            won = top_bid > neg
            lost = ((assigned_col[:, :, None] == cols[None, None, :]) & won[:, None, :]
                    & (rows[None, :, None] != top_row[:, None, :])).any(-1)
            assigned_col = torch.where(lost, UNMATCHED, assigned_col)
            prices = torch.where(won, prices + top_bid, prices)
            new_col = torch.where(won[:, None, :] & (rows[None, :, None] == top_row[:, None, :]),
                                  cols[None, None, :], -1).max(-1).values
            assigned_col = torch.where(new_col >= 0, new_col, assigned_col)
        it += min(CHECK_EVERY, max_iters - it)

    pair = torch.gather(scores, 2, assigned_col.clamp(min=0)[:, :, None])[:, :, 0]
    m0 = torch.where((assigned_col >= 0) & (pair >= min_score), assigned_col, UNMATCHED)
    valid = m0 >= 0
    m1 = torch.where((cols[None, None, :] == m0[:, :, None]) & valid[:, :, None],
                     rows[None, :, None], -1).max(1).values
    return m0, torch.where(m1 >= 0, m1, UNMATCHED), int(active)


def sample_points_on_lines(lines: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, L, 2, 2) -> (B, L, S, 2) evenly spaced samples of each segment."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=lines.dtype, device=lines.device)
    t = t[None, None, :, None]
    return lines[:, :, 0][:, :, None, :] * (1 - t) + lines[:, :, 1][:, :, None, :] * t


def point_line_distances(points: torch.Tensor, lines: torch.Tensor):
    """Distance of (B, L0, S, 2) points to the lines through (B, L1, 2, 2)
    segments, and whether the foot lies in the segment: (B, L0, S, L1) each."""
    a = lines[:, None, None, :, 0]
    b = lines[:, None, None, :, 1]
    p = points[:, :, :, None, :]
    ab = b - a
    ap = p - a
    t = (ap * ab).sum(-1) / torch.clamp((ab ** 2).sum(-1), min=1e-8)
    in_seg = (t >= 0.0) & (t <= 1.0)
    dist = torch.linalg.vector_norm(p - (a + t[..., None] * ab), dim=-1)
    return dist, in_seg


def _close_counts(segs, pts_w, valid_w, perp_dist_th: float):
    """counts[b, ls, lp]: valid warped samples of line lp within
    `perp_dist_th` of segment ls, their foot inside it."""
    dist, in_seg = point_line_distances(pts_w, segs)
    close = (dist < perp_dist_th) & in_seg & valid_w[..., None]
    return close.sum(dim=2).transpose(1, 2)


def _clamp_lines(lines: torch.Tensor, shape) -> torch.Tensor:
    h, w = shape
    hi = torch.tensor([w - 1.0, h - 1.0], dtype=lines.dtype, device=lines.device)
    return torch.minimum(torch.clamp(lines, min=0.0), hi)


def _out_of_fraction(pts_w: torch.Tensor, shape, min_visibility_th: float) -> torch.Tensor:
    """(B, L, S, 2) warped samples -> (B, L): the share outside the image
    reaches 1 - min_visibility_th."""
    h, w = shape
    wh = torch.tensor([w, h], dtype=pts_w.dtype, device=pts_w.device)
    out = (pts_w < 0).any(-1) | (pts_w >= wh).any(-1)
    return out.float().mean(-1) >= (1.0 - min_visibility_th)


def _line_gt_labels(c10, c01, mask_close, unmatched0, unmatched1, ignore0, ignore1, npts: int):
    B, L0, L1 = c10.shape
    score = (c10 * c01).float() / float(npts * npts)
    forbid = (unmatched0 | ignore0)[:, :, None] | (unmatched1 | ignore1)[:, None, :]
    m0a, m1a = auction_assignment(score.masked_fill(forbid, float("-inf")),
                                  min_score=float("-inf"), eps=1e-3)
    cols = torch.arange(L1, device=c10.device)
    positive = ((m0a[:, :, None] == cols[None, None, :]) & (m0a >= 0)[:, :, None] & mask_close
                & ~(unmatched0 | ignore0)[:, :, None] & ~(unmatched1 | ignore1)[:, None, :])
    m0 = torch.where(positive.any(-1), m0a, UNMATCHED)
    m0 = torch.where(unmatched0, UNMATCHED, m0)
    m0 = torch.where(ignore0, IGNORE, m0)
    m1 = torch.where(positive.any(-2), m1a, UNMATCHED)
    m1 = torch.where(unmatched1, UNMATCHED, m1)
    m1 = torch.where(ignore1, IGNORE, m1)
    return {"matches0": m0, "matches1": m1, "assignment": positive}


def gt_line_matches_from_homography(lines0, lines1, lmask0, lmask1, shape0, shape1, H,
                                    n_samples: int = 50, perp_dist_th: float = 5.0,
                                    overlap_th: float = 0.2, min_visibility_th: float = 0.5):
    """Lines (B, L, 2, 2) and their masks, image shapes (h, w), H (B, 3, 3)
    -> matches0 (B, L0), matches1 (B, L1) (UNMATCHED, IGNORE for masked
    lines) and the positive assignment (B, L0, L1)."""
    B = lines0.shape[0]
    lines0 = _clamp_lines(lines0, shape0)
    lines1 = _clamp_lines(lines1, shape1)
    s0 = sample_points_on_lines(lines0, n_samples)
    s1 = sample_points_on_lines(lines1, n_samples)
    s0_w = warp_points(s0.reshape(B, -1, 2), H).reshape(s0.shape)
    s1_w = warp_points(s1.reshape(B, -1, 2), H, inverse=True).reshape(s1.shape)
    out_of0 = _out_of_fraction(s1_w, shape0, min_visibility_th)
    out_of1 = _out_of_fraction(s0_w, shape1, min_visibility_th)
    c10 = _close_counts(lines0, s1_w, torch.ones(s1.shape[:3], dtype=torch.bool,
                                                 device=s1.device), perp_dist_th)
    c01 = _close_counts(lines1, s0_w, torch.ones(s0.shape[:3], dtype=torch.bool,
                                                 device=s0.device), perp_dist_th).transpose(1, 2)
    th = n_samples * overlap_th
    mask_close = (c01 > th) & (c10 > th) & ~out_of0[:, None, :] & ~out_of1[:, :, None]
    unmatched0 = (~mask_close).all(2) | out_of1
    unmatched1 = (~mask_close).all(1) | out_of0
    return _line_gt_labels(c10, c01, mask_close, unmatched0, unmatched1, ~lmask0, ~lmask1,
                           n_samples)


def gt_line_matches_from_pose_depth(lines0, lines1, lmask0, lmask1, camera0: Camera,
                                    camera1: Camera, T_0to1: Pose, depth0, depth1, shape0=None,
                                    shape1=None, n_samples: int = 50, perp_dist_th: float = 5.0,
                                    overlap_th: float = 0.2, min_visibility_th: float = 0.5):
    """Line GT from depth maps (B, H, W) and the relative pose: samples
    projected both ways, counts weighted by the projections' validity,
    thresholds relative to each line's visible samples; lines with too few
    valid depths IGNORE. Shapes default to the depth maps'."""
    B, L0 = lines0.shape[:2]
    L1 = lines1.shape[1]
    shape0 = tuple(depth0.shape[-2:]) if shape0 is None else shape0
    shape1 = tuple(depth1.shape[-2:]) if shape1 is None else shape1
    lines0 = _clamp_lines(lines0, shape0)
    lines1 = _clamp_lines(lines1, shape1)
    s0 = sample_points_on_lines(lines0, n_samples).reshape(B, L0 * n_samples, 2)
    s1 = sample_points_on_lines(lines1, n_samples).reshape(B, L1 * n_samples, 2)
    d0, v0 = sample_depth(s0, depth0)
    d1, v1 = sample_depth(s1, depth1)
    s0_w, vw0 = project(s0, d0, depth1, camera0, camera1, T_0to1, v0)
    s1_w, vw1 = project(s1, d1, depth0, camera1, camera0, T_0to1.inv(), v1)
    s0_w = s0_w.reshape(B, L0, n_samples, 2)
    s1_w = s1_w.reshape(B, L1, n_samples, 2)
    vw0 = vw0.reshape(B, L0, n_samples)
    vw1 = vw1.reshape(B, L1, n_samples)
    out_of0 = _out_of_fraction(s1_w, shape0, min_visibility_th)
    out_of1 = _out_of_fraction(s0_w, shape1, min_visibility_th)
    c10 = _close_counts(lines0, s1_w, vw1, perp_dist_th)
    c01 = _close_counts(lines1, s0_w, vw0, perp_dist_th).transpose(1, 2)
    nvis0 = vw0.sum(-1).float()
    nvis1 = vw1.sum(-1).float()
    mask_close = (c01 > nvis0[:, :, None] * overlap_th) & (c10 > nvis1[:, None, :] * overlap_th)
    unmatched0 = (~mask_close).all(2) | out_of1
    unmatched1 = (~mask_close).all(1) | out_of0
    ignore0 = (v0.reshape(B, L0, n_samples).float().mean(-1) < min_visibility_th) | ~lmask0
    ignore1 = (v1.reshape(B, L1, n_samples).float().mean(-1) < min_visibility_th) | ~lmask1
    return _line_gt_labels(c10, c01, mask_close, unmatched0, unmatched1, ignore0, ignore1,
                           n_samples)
