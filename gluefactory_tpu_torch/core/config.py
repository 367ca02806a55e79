"""Immutable, hashable nested configuration.

The port's own copy of `gluefactory_tpu/core/config.py` (pure Python and
YAML): a minimal OmegaConf-compatible replacement with the YAML surface of
glue-factory (`train.py` merges yaml < CLI dotlist; `models/base_model.py`
merges class defaults < user conf and freezes). All mutation is by
functional `merge`, so one conf object can be shared by several modules.
"""

from __future__ import annotations

import io
from typing import Any, Iterator, Mapping

import yaml

__all__ = ["Config", "merge", "to_dict", "from_yaml", "from_dotlist"]


def _convert(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return tuple(_convert(v) for v in value)
    if isinstance(value, (str, int, float, bool, bytes)) or value is None:
        return value
    # Leave other leaves (e.g. callables for plot hooks) untouched.
    return value


def _plain(value: Any) -> Any:
    if isinstance(value, Config):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return [_plain(v) for v in value]
    return value


class Config(Mapping):
    """Immutable nested mapping with attribute access and deep merge."""

    __slots__ = ("_data", "_hash")

    def __init__(self, data: Mapping | None = None, **kwargs):
        items = {}
        if data is not None:
            for k, v in dict(data).items():
                items[str(k)] = _convert(v)
        for k, v in kwargs.items():
            items[str(k)] = _convert(v)
        object.__setattr__(self, "_data", items)
        object.__setattr__(self, "_hash", None)

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    # -- attribute access -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        raise TypeError("Config is immutable; use merge() to derive a new one")

    # immutable: a copy is the object itself (copy.deepcopy of a model holding one)
    def __copy__(self) -> "Config":
        return self

    def __deepcopy__(self, memo) -> "Config":
        return self

    # -- identity ---------------------------------------------------------
    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, Mapping):
            return _plain(self) == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        h = object.__getattribute__(self, "_hash")
        if h is None:
            h = hash(_freeze(self._data))
            object.__setattr__(self, "_hash", h)
        return h

    def __repr__(self) -> str:
        return f"Config({_plain(self)!r})"

    # -- helpers ----------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def select(self, dotted: str, default: Any = None) -> Any:
        """Look up a dotted path, e.g. conf.select('model.extractor.name')."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Config) or part not in node:
                return default
            node = node[part]
        return node

    def merge_with(self, *others: Mapping) -> "Config":
        return merge(self, *others)

    def set(self, dotted: str, value: Any) -> "Config":
        """Return a new Config with `dotted` path set to `value`."""
        parts = dotted.split(".")
        patch: Any = value
        for part in reversed(parts):
            patch = {part: patch}
        return merge(self, patch)

    def to_dict(self) -> dict:
        return _plain(self)

    def to_yaml(self) -> str:
        return yaml.safe_dump(_plain(self), sort_keys=False)


def _freeze(value: Any):
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, Config):
        return _freeze(value._data)
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


def merge(*configs: Mapping | None, strict: bool = False) -> Config:
    """Deep merge, later configs override earlier ones.

    With ``strict=True`` a key appearing in a later config but not in the first
    raises (typo guard — mirrors omegaconf struct mode used by the reference's
    `BaseModel.__init__`, `models/base_model.py:84-90`). Keys are exempt under a
    subtree whose first-config value is an empty dict (open container).
    """
    base: dict = {}
    first = True
    for conf in configs:
        if conf is None:
            continue
        _merge_into(base, conf, strict=strict and not first, path="")
        first = False
    return Config(base)


def _merge_into(dst: dict, src: Mapping, strict: bool, path: str) -> None:
    items = src._data if isinstance(src, Config) else src
    for key, value in items.items():
        key = str(key)
        here = f"{path}.{key}" if path else key
        if strict and key not in dst:
            raise KeyError(f"unknown config key: {here}")
        current = dst.get(key)
        if isinstance(value, (Mapping, Config)) and isinstance(current, dict):
            # an empty default dict means "accept any keys"
            _merge_into(current, value, strict=strict and len(current) > 0, path=here)
        elif isinstance(value, (Mapping, Config)):
            sub: dict = {}
            _merge_into(sub, value, strict=False, path=here)
            dst[key] = sub
        else:
            dst[key] = _plain(_convert(value))


def to_dict(conf: Mapping) -> dict:
    return conf.to_dict() if isinstance(conf, Config) else dict(conf)


def from_yaml(source: str | io.IOBase) -> Config:
    """Load a Config from a YAML string, file object, or path."""
    import os

    if isinstance(source, (str, os.PathLike)) and (
        str(source).endswith((".yaml", ".yml")) or os.path.exists(str(source))
    ):
        with open(source) as f:
            data = yaml.safe_load(f)
    else:
        data = yaml.safe_load(source)
    return Config(data or {})


def load_yaml_path(path) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def _parse_value(text: str) -> Any:
    value = yaml.safe_load(text)
    if isinstance(value, str):
        # YAML 1.1 misses bare scientific notation like "1e-4"
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


def from_dotlist(dotlist: list[str]) -> Config:
    """Build a Config from CLI dotlist overrides, e.g. ['train.lr=1e-4'].

    Mirrors `OmegaConf.from_cli` used by `train.py:711` / `eval/io.py:78`.
    """
    out: dict = {}
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist entry must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_value(value)
    return Config(out)
