"""Base class for all models: conf-merged `torch.nn.Module`s.

Counterpart of `gluefactory_tpu/models/base_model.py` (role of glue-factory's
`models/base_model.py`): `default_conf` merged down the inheritance chain,
`required_data_keys` validation, `_forward(data) -> pred`,
`loss(pred, data) -> (losses, metrics)` with (B,) vectors and the total under
"total". A model built with `trainable: False` has every parameter frozen
(`requires_grad=False`).

The `train` argument of `forward`, `forward_with_loss` and `loss` is the JAX
package's flag: it selects the loss terms (LightGlue's deep supervision and
token-confidence BCE at train, `matcher_metrics` at eval), SuperPoint's
keypoint count (`max_num_keypoints_val` only at eval) and SuperGlue's
BatchNorm mode (by the batch, updating the running statistics, at train).
It is kept apart from `torch.nn.Module.train()`, whose mode decides nothing
in these models (they have no dropout, and BatchNorm follows the flag), so
a model behaves the same in either mode for the same flag.

Entry points run on the card: `Model.from_conf(conf)` places the model on
`cuda` unless the caller passes another `device` (the tests pass "cpu").
"""

from __future__ import annotations

from typing import Any, ClassVar

import torch
from torch import nn

from ..core.config import Config, merge

__all__ = ["BaseModel"]


class BaseModel(nn.Module):
    """Conf-driven model base.

    Subclasses define `default_conf` / `required_data_keys` and implement
    `_init(conf)` (build submodules) and `_forward(data)`. Build with
    `MyModel.from_conf({...})` so defaults are merged and validated; the plain
    constructor takes a fully merged conf.
    """

    base_default_conf: ClassVar[dict] = {
        "name": None,
        "trainable": True,
        "freeze_batch_normalization": False,
        "timeit": False,
        "weights_file": None,
    }
    default_conf: ClassVar[dict] = {}
    required_data_keys: ClassVar[list] = []
    strict_conf: ClassVar[bool] = True

    def __init__(self, conf: Config):
        super().__init__()
        self.conf = conf
        self._init(conf)
        if not conf.trainable:
            for p in self.parameters():
                p.requires_grad_(False)

    @classmethod
    def merged_default_conf(cls) -> Config:
        """Merge `default_conf` down the inheritance chain."""
        out: dict = dict(BaseModel.base_default_conf)
        for klass in reversed(cls.__mro__):
            d = klass.__dict__.get("default_conf")
            if d:
                out = merge(Config(out), d).to_dict()
        return Config(out)

    @classmethod
    def resolve_conf(cls, conf: Any = None) -> Config:
        defaults = cls.merged_default_conf()
        if conf is None:
            return defaults
        if isinstance(conf, Config):
            conf = conf.to_dict()
        return merge(defaults, conf, strict=cls.strict_conf)

    @classmethod
    def from_conf(cls, conf: Any = None, device: str | torch.device = "cuda") -> "BaseModel":
        return cls(cls.resolve_conf(conf)).to(device)

    def _init(self, conf: Config) -> None:
        raise NotImplementedError

    def forward(self, data: dict, **kwargs) -> dict:
        for key in self.required_data_keys:
            if key not in data:
                raise KeyError(f"missing required data key {key} for {type(self).__name__}")
        return self._forward(data, **kwargs)

    def _forward(self, data: dict, **kwargs) -> dict:
        raise NotImplementedError

    def forward_with_loss(self, data: dict, train: bool = True, **kwargs):
        """(pred, losses, metrics): the forward and the loss with one `train`
        flag, the train step's entry point. `kwargs` go to the forward (the
        pipeline's `generator`)."""
        pred = self(data, train=train, **kwargs)
        losses, metrics = self.loss(pred, data, train=train)
        return pred, losses, metrics

    def loss(self, pred: dict, data: dict, train: bool = False):
        """(losses, metrics): dicts of (B,) tensors, the total under "total"."""
        raise NotImplementedError

    @property
    def is_trainable(self) -> bool:
        return bool(self.conf.get("trainable", True))
