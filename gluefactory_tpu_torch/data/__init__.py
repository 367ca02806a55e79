"""Datasets and data loading for training (counterpart of
`gluefactory_tpu/data/`). `get_dataset(name)` resolves a module name of this
package (e.g. "homographies") or a dotted path to its BaseDataset subclass."""

from __future__ import annotations

import importlib
import importlib.util
import inspect

from .base_dataset import BaseDataset


def get_dataset(name: str):
    for path in (f"{__name__}.{name}", name):
        try:
            spec = importlib.util.find_spec(path)
        except (ModuleNotFoundError, ValueError):
            spec = None
        if spec is None:
            continue
        mod = importlib.import_module(path)
        classes = [c for _, c in inspect.getmembers(mod, inspect.isclass)
                   if issubclass(c, BaseDataset) and c is not BaseDataset and c.__module__ == path]
        if len(classes) != 1:
            raise RuntimeError(f"expected one dataset in {path}, found {len(classes)}")
        return classes[0]
    raise RuntimeError(f"dataset {name} not found")
