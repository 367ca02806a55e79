"""Matcher metrics against ground truth (counterpart of
`gluefactory_tpu/models/metrics.py`): recall over GT positives, precision
and accuracy over predicted / non-ignored slots, and a ranking "average
precision" from the matching-score order. `ranking_ap` scales the recall
increments by the final precision point only (`p_pts[:, None, -1]`), as the
JAX package and the reference do. Padding slots are labelled IGNORE (-2) by
the GT generators and drop out of every mask.
"""

from __future__ import annotations

import torch


def _recall(m, gt_m):
    mask = (gt_m > -1).float()
    return ((m == gt_m) * mask).sum(1) / (1e-8 + mask.sum(1))


def _accuracy(m, gt_m):
    mask = (gt_m >= -1).float()
    return ((m == gt_m) * mask).sum(1) / (1e-8 + mask.sum(1))


def _precision(m, gt_m):
    mask = ((m > -1) & (gt_m >= -1)).float()
    return ((m == gt_m) * mask).sum(1) / (1e-8 + mask.sum(1))


def _ranking_ap(m, gt_m, scores):
    p_mask = ((m > -1) & (gt_m >= -1)).float()
    r_mask = (gt_m > -1).float()
    # stable: equal scores keep their index order, as jnp.argsort does
    sort_ind = torch.argsort(-scores, dim=-1, stable=True)
    sorted_p_mask = torch.gather(p_mask, -1, sort_ind)
    sorted_r_mask = torch.gather(r_mask, -1, sort_ind)
    sorted_tp = torch.gather((m == gt_m).float(), -1, sort_ind)
    p_pts = torch.cumsum(sorted_tp * sorted_p_mask, -1) / (1e-8 + torch.cumsum(sorted_p_mask, -1))
    r_pts = torch.cumsum(sorted_tp * sorted_r_mask, -1) / (1e-8 + sorted_r_mask.sum(-1)[:, None])
    r_pts_diff = r_pts[..., 1:] - r_pts[..., :-1]
    return torch.sum(r_pts_diff * p_pts[:, None, -1], dim=-1)


def matcher_metrics(pred: dict, data: dict, prefix: str = "", prefix_gt: str | None = None) -> dict:
    """recall / precision / accuracy / ranking AP of `{prefix}matches0`
    against `gt_{prefix_gt}matches0`, each (B,)."""
    if prefix_gt is None:
        prefix_gt = prefix
    m0 = pred[f"{prefix}matches0"]
    gt_m0 = data[f"gt_{prefix_gt}matches0"]
    return {
        f"{prefix}match_recall": _recall(m0, gt_m0),
        f"{prefix}match_precision": _precision(m0, gt_m0),
        f"{prefix}accuracy": _accuracy(m0, gt_m0),
        f"{prefix}average_precision": _ranking_ap(m0, gt_m0, pred[f"{prefix}matching_scores0"]),
    }
