"""Dense descriptor nearest-neighbour matcher (counterpart of
`gluefactory_tpu/models/matchers/nearest_neighbor_matcher.py`).

The cosine similarity of the two views' descriptors (padded keypoints at
-1e9), nearest neighbours both ways with the optional ratio and distance
tests (`ops/assignment.find_nn`), the mutual check, binary matching scores,
and the dual-softmax log assignment padded to (M+1, N+1) with zero
dustbins. With `loss: N_pair`, the N-pair contrastive loss with a learned
`temperature`; without it the matcher has no parameter and no loss.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.assignment import NEG_INF, find_nn, mutual_check
from ..base_model import BaseModel
from ..metrics import matcher_metrics


class NearestNeighborMatcher(BaseModel):
    default_conf = {
        "ratio_thresh": None,
        "distance_thresh": None,
        "mutual_check": True,
        "loss": None,  # None | "N_pair"
    }
    required_data_keys = ["descriptors0", "descriptors1"]

    def _init(self, conf):
        if conf.loss == "N_pair":
            self.temperature = nn.Parameter(torch.tensor(1.0))

    def _forward(self, data: dict, train: bool = False) -> dict:
        mask0, mask1 = data.get("keypoint_mask0"), data.get("keypoint_mask1")
        sim = torch.einsum("bnd,bmd->bnm", data["descriptors0"], data["descriptors1"])
        return self.match_similarity(sim, mask0, mask1)

    def match_similarity(self, sim, mask0=None, mask1=None) -> dict:
        """The matcher's outputs from the similarity (B, M, N) and the
        keypoint masks."""
        c = self.conf
        if mask0 is not None:
            sim = sim.masked_fill(~mask0[..., :, None], NEG_INF)
        if mask1 is not None:
            sim = sim.masked_fill(~mask1[..., None, :], NEG_INF)
        matches0, _ = find_nn(sim, c.ratio_thresh, c.distance_thresh)
        matches1, _ = find_nn(sim.transpose(1, 2), c.ratio_thresh, c.distance_thresh)
        if c.mutual_check:
            matches0 = mutual_check(matches0, matches1)
            matches1 = mutual_check(matches1, matches0)
        if mask0 is not None:
            matches0 = torch.where(mask0, matches0, -1)
        if mask1 is not None:
            matches1 = torch.where(mask1, matches1, -1)
        b, m, n = sim.shape
        la = sim.new_zeros((b, m + 1, n + 1))
        la[:, :-1, :-1] = sim.log_softmax(-1) + sim.log_softmax(-2)
        return {
            "matches0": matches0,
            "matches1": matches1,
            "matching_scores0": (matches0 > -1).to(sim.dtype),
            "matching_scores1": (matches1 > -1).to(sim.dtype),
            "similarity": sim,
            "log_assignment": la,
        }

    def loss(self, pred: dict, data: dict, train: bool = False):
        """N-pair loss: scores temperature * (2 - sqrt(max(2 (1 - sim),
        1e-6))), log-softmax along each axis, the GT assignment's mean NLL
        over both; `matcher_metrics` only at eval."""
        if self.conf.loss != "N_pair":
            raise NotImplementedError
        sim = pred["similarity"]
        scores = self.temperature * (2.0 - torch.sqrt((2.0 * (1.0 - sim)).clamp(min=1e-6)))
        assignment = data["gt_assignment"].to(scores.dtype)
        num = assignment.sum((1, 2)).clamp(min=1.0)
        nll0 = (scores.log_softmax(2) * assignment).sum((1, 2)) / num
        nll1 = (scores.log_softmax(1) * assignment).sum((1, 2)) / num
        nll = -(nll0 + nll1) / 2.0
        losses = {
            "n_pair_nll": nll,
            "total": nll,
            "num_matchable": num,
            "n_pair_temperature": self.temperature[None],
        }
        if train or "gt_matches0" not in data:
            return losses, {}
        return losses, matcher_metrics(pred, data)
