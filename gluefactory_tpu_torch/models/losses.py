"""Matcher NLL losses (counterpart of `gluefactory_tpu/models/losses.py`).

Two clamp conventions coexist and both are kept:
  - LightGlue's `weight_loss` clamps the negative count of EACH side to >= 1
    before summing, and reports `num_unmatchable = (num_neg0 + num_neg1) / 2`;
  - SuperGlue and GlueStick clamp the SUM of the negative counts to >= 1
    and report the clamped sum.
All outputs are per-sample (B,) vectors.
"""

from __future__ import annotations

import torch

__all__ = ["nll_components", "masked_row_norm"]


def nll_components(log_assignment, gt_assignment, gt_matches0, gt_matches1, per_side_clamp: bool):
    """NLL of a (B, M+1, N+1) log assignment against GT:
    (nll_pos, nll_neg, num_matchable, num_unmatchable), each (B,).
    `per_side_clamp` selects LightGlue's convention, else SuperGlue's."""
    gt = gt_assignment.to(log_assignment.dtype)
    M, N = gt.shape[1], gt.shape[2]
    num_pos = gt.sum((-1, -2)).clamp(min=1.0)
    nll_pos = -(log_assignment[:, :M, :N] * gt).sum((-1, -2)) / num_pos

    neg0 = (gt_matches0 == -1).to(log_assignment.dtype)
    neg1 = (gt_matches1 == -1).to(log_assignment.dtype)
    nll_neg0 = -(log_assignment[:, :M, N] * neg0).sum(-1)
    nll_neg1 = -(log_assignment[:, M, :N] * neg1).sum(-1)
    if per_side_clamp:
        num_neg0 = neg0.sum(-1).clamp(min=1.0)
        num_neg1 = neg1.sum(-1).clamp(min=1.0)
        nll_neg = (nll_neg0 + nll_neg1) / (num_neg0 + num_neg1)
        num_unmatchable = (num_neg0 + num_neg1) / 2.0
    else:
        num_unmatchable = (neg0.sum(-1) + neg1.sum(-1)).clamp(min=1.0)
        nll_neg = (nll_neg0 + nll_neg1) / num_unmatchable
    return nll_pos, nll_neg, num_pos, num_unmatchable


def masked_row_norm(log_assignment, mask=None):
    """Mean probability mass of the non-dustbin rows, a training-health
    diagnostic; over the real rows when `mask` (B, M) is given."""
    row_sums = log_assignment[:, :-1].float().exp().sum(2)
    if mask is None:
        return row_sums.mean(1)
    m = mask.to(row_sums.dtype)
    return (row_sums * m).sum(1) / m.sum(1).clamp(min=1.0)
