"""Robust estimator registry (counterpart of
`gluefactory_tpu/robust_estimators/__init__.py`): `load_estimator(type_,
name)` imports `robust_estimators.<type_>.<name>` of this package and
returns its one `BaseEstimator` subclass. Ported: `homography.xla_ransac`,
`homography.homography_est` (points and lines), `relative_pose.xla_ransac`
and `relative_pose.two_view_native` (the batched RANSACs on the device, the
latter with COLMAP's model selection); `homography.poselib` and
`relative_pose.poselib` (the in-repo C++ LO-RANSAC on the host,
`native.py`); `homography.opencv` and `relative_pose.opencv` (cv2 on the
host). `relative_pose.pycolmap` needs pycolmap, which neither package
has."""

from __future__ import annotations

import importlib
import inspect

from .base_estimator import BaseEstimator


def load_estimator(type_: str, name: str):
    mod = importlib.import_module(f"{__name__}.{type_}.{name}")
    classes = [c for _, c in inspect.getmembers(mod, inspect.isclass)
               if issubclass(c, BaseEstimator) and c is not BaseEstimator
               and c.__module__ == mod.__name__]
    if len(classes) != 1:
        raise RuntimeError(f"expected one estimator in {mod.__name__}, found {len(classes)}")
    return classes[0]
