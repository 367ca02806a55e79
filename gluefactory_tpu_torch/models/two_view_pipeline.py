"""Two-view pipeline: extractor -> matcher -> filter -> solver, with ground
truth and the loss for training (counterpart of
`gluefactory_tpu/models/two_view_pipeline.py`). The filter and the solver,
where the conf names them, run after the matcher on the predictions merged
so far, each adding its outputs.

Per-view inputs live under `data["view0"/"view1"]`; extractor outputs are
suffixed `0`/`1` into the flat prediction dict. With `batch_extraction`,
views of one image shape go through the extractor as one stacked batch.
Submodules are named `extractor`, `matcher` and `ground_truth`, as in
glue-factory's checkpoints.

A frozen extractor (`trainable: False`) runs under `torch.no_grad()`, so its
outputs carry no graph (the JAX package cuts its gradients with
`stop_gradient`; the update is the same and no activation is kept). The
`ground_truth` component (e.g. `homography_matcher`) runs in the forward
with `run_gt_in_forward`, else in `loss`, which sums the losses of the
trainable components under `{component}_{key}` names, the sum under
"total".
"""

from __future__ import annotations

import contextlib

import torch

from . import get_model
from .base_model import BaseModel

# per-view inputs the extractor may consume, stacked with the images
_STACKED_KEYS = ("image", "image_size")


class TwoViewPipeline(BaseModel):
    default_conf = {
        "extractor": {"name": None},
        "matcher": {"name": None},
        "filter": {"name": None},
        "solver": {"name": None},
        "ground_truth": {"name": None},
        "allow_no_extract": False,
        "run_gt_in_forward": False,
        "batch_extraction": True,
    }
    required_data_keys = ["view0", "view1"]
    strict_conf = False
    components = ("extractor", "matcher", "filter", "solver", "ground_truth")

    def _init(self, conf):
        for comp in self.components:
            sub = conf[comp]
            model = None
            if sub.get("name"):
                cls = get_model(sub.name)
                model = cls(cls.resolve_conf({k: v for k, v in sub.to_dict().items() if k != "name"}))
            setattr(self, comp, model)

    def _extract(self, data: dict, generator, train: bool) -> dict:
        """The extractor on `data`, under no_grad when it is frozen."""
        frozen = not self.extractor.is_trainable
        with torch.no_grad() if frozen else contextlib.nullcontext():
            return self.extractor(data, generator=generator, train=train)

    def extract_view(self, data: dict, i: str, generator=None, train: bool = False) -> dict:
        data_i = data[f"view{i}"]
        pred_i = dict(data_i.get("cache", {}))
        skip_extract = len(pred_i) > 0 and self.conf.allow_no_extract
        if self.extractor is not None and not skip_extract:
            pred_i = {**self._extract({**data_i, **pred_i}, generator, train), **pred_i}
        return pred_i

    def _can_batch_extraction(self, data: dict) -> bool:
        if not self.conf.batch_extraction or self.extractor is None:
            return False
        v0, v1 = data["view0"], data["view1"]
        if "cache" in v0 or "cache" in v1:
            return False
        return "image" in v0 and "image" in v1 and v0["image"].shape == v1["image"].shape

    def _extract_stacked(self, data: dict, generator=None, train: bool = False):
        v0, v1 = data["view0"], data["view1"]
        B = v0["image"].shape[0]
        stacked = {k: torch.cat([v0[k], v1[k]], dim=0) for k in _STACKED_KEYS if k in v0 and k in v1}
        pred = self._extract(stacked, generator, train)
        return {k: v[:B] for k, v in pred.items()}, {k: v[B:] for k, v in pred.items()}

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        """`generator` goes to the extractor (SuperPoint's keypoint fill and
        sampling)."""
        if self._can_batch_extraction(data):
            pred0, pred1 = self._extract_stacked(data, generator, train)
        else:
            pred0 = self.extract_view(data, "0", generator, train)
            pred1 = self.extract_view(data, "1", generator, train)
        pred = {**{k + "0": v for k, v in pred0.items()}, **{k + "1": v for k, v in pred1.items()}}
        for comp in ("matcher", "filter", "solver"):
            model = getattr(self, comp)
            if model is not None:
                pred = {**pred, **model({**data, **pred}, train=train)}
        if self.conf.run_gt_in_forward and self.ground_truth is not None:
            pred = {**pred, **self.ground_truth({**data, **pred}, train=train)}
        return pred

    def loss(self, pred: dict, data: dict, train: bool = False):
        if not self.conf.run_gt_in_forward and self.ground_truth is not None:
            pred = {**pred, **self.ground_truth({**data, **pred}, train=train)}
        losses, metrics, total = {}, {}, 0
        for comp in ("extractor", "matcher", "filter", "solver"):
            model = getattr(self, comp)
            if model is None or not model.is_trainable:
                continue
            try:
                losses_c, metrics_c = model.loss(pred, {**pred, **data}, train=train)
            except NotImplementedError:
                continue
            losses.update({f"{comp}_{k}": v for k, v in losses_c.items() if k != "total"})
            metrics.update(metrics_c)
            total = losses_c["total"] + total
        losses["total"] = total
        return losses, metrics
