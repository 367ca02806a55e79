"""Estimator base (counterpart of
`gluefactory_tpu/robust_estimators/base_estimator.py`): the conf is the
base defaults, then the subclass's, then the caller's."""

from __future__ import annotations

from ..core.config import Config, merge


class BaseEstimator:
    base_default_conf = {"name": None, "ransac_th": 2.0}
    default_conf: dict = {}

    def __init__(self, conf=None):
        defaults = merge(Config(self.base_default_conf), self.default_conf)
        self.conf = merge(defaults, conf or {})
        self._init(self.conf)

    def _init(self, conf):
        pass

    def __call__(self, data: dict) -> dict:
        """`data` holds the matched points (`m_kpts0`, `m_kpts1`); returns
        {success, M_0to1, inliers}."""
        return self._forward(data)

    def _forward(self, data: dict) -> dict:
        raise NotImplementedError
