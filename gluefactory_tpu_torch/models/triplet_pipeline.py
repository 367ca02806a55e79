"""Triplet pipeline: three views, three pairs (counterpart of
`gluefactory_tpu/models/triplet_pipeline.py`).

Each view goes through the extractor alone; the pairs 0to1, 0to2 and 1to2
then go through the matcher, stacked on the batch axis into one pass of 3B
(`batch_triplets`, the default) or one pass each. Pair outputs are named
`<key>_<pair>`, view outputs `<key><view>`. The loss runs the ground truth
on each pair and sums the matcher's losses over the pairs (`<key>_<pair>`,
the sum under "total").
"""

from __future__ import annotations

import torch

from ..utils.misc import get_twoview_data, map_multi, unstack_twoviews
from .two_view_pipeline import TwoViewPipeline

PAIR_INDICES = ("0to1", "0to2", "1to2")


class TripletPipeline(TwoViewPipeline):
    default_conf = {
        "batch_triplets": True,
    }
    required_data_keys = ["view0", "view1", "view2"]

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        preds = {i: self.extract_view(data, i, generator, train) for i in "012"}
        views = {f"{k}{i}": v for i in preds for k, v in preds[i].items()}
        if self.matcher is None:
            return views
        B = data["view0"]["image" if "image" in data["view0"] else "image_size"].shape[0]
        if self.conf.batch_triplets:
            stacked_data = map_multi([get_twoview_data(data, idx) for idx in PAIR_INDICES])
            stacked_pred = {}
            for idx in PAIR_INDICES:
                i, j = idx[0], idx[-1]
                for k in preds[i]:
                    stacked_pred.setdefault(k + "0", []).append(preds[i][k])
                    stacked_pred.setdefault(k + "1", []).append(preds[j][k])
            stacked_pred = {k: torch.cat(v, dim=0) for k, v in stacked_pred.items()}
            per_pair = unstack_twoviews(self.matcher({**stacked_data, **stacked_pred}, train=train),
                                        B, PAIR_INDICES)
        else:
            per_pair = {}
            for idx in PAIR_INDICES:
                i, j = idx[0], idx[-1]
                pair_pred = {**{k + "0": v for k, v in preds[i].items()},
                             **{k + "1": v for k, v in preds[j].items()}}
                per_pair[idx] = self.matcher({**get_twoview_data(data, idx), **pair_pred},
                                             train=train)
        for idx, p in per_pair.items():
            views.update({f"{k}_{idx}": v for k, v in p.items()})
        return views

    def loss(self, pred: dict, data: dict, train: bool = False):
        """The sum over the pairs of the matcher's losses, each pair's ground
        truth computed first."""
        total, losses, metrics = 0, {}, {}
        view_keys = [k for k in pred if not any(k.endswith(f"_{x}") for x in PAIR_INDICES)]
        for idx in PAIR_INDICES:
            i, j = idx[0], idx[-1]
            pair_data = get_twoview_data(data, idx)
            pair_pred = {k[:-len(idx) - 1]: v for k, v in pred.items() if k.endswith(f"_{idx}")}
            pair_pred.update({k[:-1] + "0": pred[k] for k in view_keys if k.endswith(i)})
            pair_pred.update({k[:-1] + "1": pred[k] for k in view_keys if k.endswith(j)})
            if self.ground_truth is not None:
                pair_pred = {**pair_pred, **self.ground_truth({**pair_data, **pair_pred}, train=train)}
            if self.matcher is not None and self.matcher.is_trainable:
                losses_i, metrics_i = self.matcher.loss(pair_pred, {**pair_pred, **pair_data},
                                                        train=train)
                total = total + losses_i["total"]
                losses.update({f"{k}_{idx}": v for k, v in losses_i.items() if k != "total"})
                metrics.update({f"{k}_{idx}": v for k, v in metrics_i.items()})
        losses["total"] = total
        return losses, metrics
