"""A detector and a descriptor model combined (counterpart of
`gluefactory_tpu/models/extractors/mixed.py`): the detector's outputs,
over the descriptor model's (run on the data and the detections), and with
`interpolate_descriptors_from` the descriptors sampled at the detector's
keypoints from the descriptor model's dense map of that key
(`ops/grid_sample.sample_descriptors` at `descriptor_stride`)."""

from __future__ import annotations

import torch

from ...ops.grid_sample import sample_descriptors
from .. import get_model
from ..base_model import BaseModel


class MixedExtractor(BaseModel):
    default_conf = {
        "detector": {"name": None},
        "descriptor": {"name": None},
        "interpolate_descriptors_from": None,  # key of a dense descriptor map
        "descriptor_stride": 8,
    }
    required_data_keys = ["image"]
    strict_conf = False

    def _init(self, conf):
        for comp in ("detector", "descriptor"):
            sub = conf.get(comp)
            model = None
            if sub and sub.get("name"):
                cls = get_model(sub.name)
                model = cls(cls.resolve_conf({k: v for k, v in sub.to_dict().items() if k != "name"}))
            setattr(self, f"{comp}_model", model)

    def _forward(self, data: dict, generator: torch.Generator | None = None, train: bool = False) -> dict:
        pred: dict = {}
        if self.detector_model is not None:
            pred.update(self.detector_model(data, generator=generator, train=train))
        if self.descriptor_model is not None:
            dpred = self.descriptor_model({**data, **pred}, generator=generator, train=train)
            pred = {**dpred, **pred}
            key = self.conf.interpolate_descriptors_from
            if key is not None and key in dpred:
                pred["descriptors"] = sample_descriptors(pred["keypoints"], dpred[key],
                                                         stride=self.conf.descriptor_stride)
        return pred

    def loss(self, pred, data, train: bool = False):
        losses, metrics, total = {}, {}, 0
        for comp in ("detector", "descriptor"):
            model = getattr(self, f"{comp}_model")
            if model is None or not model.is_trainable:
                continue
            try:
                losses_c, metrics_c = model.loss(pred, data, train=train)
            except NotImplementedError:
                continue
            losses.update(losses_c)
            metrics.update(metrics_c)
            total = total + losses_c["total"]
        losses["total"] = total
        return losses, metrics
