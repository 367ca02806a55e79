"""Model registry (counterpart of `gluefactory_tpu/models/__init__.py`).

`get_model(name)` resolves a name like "two_view_pipeline",
"matchers.lightglue", "superpoint", "wireframe" or a full dotted path to the BaseModel
subclass defined in that module.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect

from .base_model import BaseModel


def get_class(mod_path: str, base_class):
    """Import a module and return its unique subclass of `base_class`."""
    mod = importlib.import_module(mod_path)
    classes = [
        c
        for _, c in inspect.getmembers(mod, inspect.isclass)
        if issubclass(c, base_class) and c is not base_class and c.__module__ == mod_path
    ]
    if len(classes) != 1:
        raise RuntimeError(f"expected exactly one model in {mod_path}, found {len(classes)}")
    return classes[0]


_SEARCH_PREFIXES = [
    "gluefactory_tpu_torch.models.",
    "gluefactory_tpu_torch.models.extractors.",
    "gluefactory_tpu_torch.models.matchers.",
    "gluefactory_tpu_torch.models.lines.",
    "",
]


def get_model(name: str):
    for prefix in _SEARCH_PREFIXES:
        path = prefix + name
        try:
            spec = importlib.util.find_spec(path)
        except (ModuleNotFoundError, ValueError):
            spec = None
        if spec is not None:
            return get_class(path, BaseModel)
    raise RuntimeError(f"model {name} not found in any of {_SEARCH_PREFIXES}")
