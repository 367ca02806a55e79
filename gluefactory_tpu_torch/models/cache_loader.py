"""Cached features read per item (counterpart of
`gluefactory_tpu/models/cache_loader.py`), for training without the
extractor: `data[viewX]["cache"]` with the pipeline's `allow_no_extract`.

Runs on the host, in the loader's workers. `CacheLoader` reads an item's
group from an HDF5 cache (the path a format string of the item's fields,
e.g. `exports/megadepth-.../{scene}.h5`, relative to `DATA_PATH`) through
`data/hdf5.py` (no h5py), keeping one open `H5File` per file; casts its
floats to `numeric_type`; scales keypoints and lines by the item's
`scales` (the export stores them at the original resolution); and pads
them to `padding_length` with a validity mask (`pad_local_features`), so
that batches keep one shape.
"""

from __future__ import annotations

import string
from pathlib import Path

import numpy as np

from .. import settings
from ..core.config import Config, merge
from ..data.hdf5 import H5File


def pad_to_length(x: np.ndarray, length: int, pad_dim: int = 0, mode: str = "zeros"):
    """x padded (zeros, or with `random_c` its edge repeated) or cut along
    `pad_dim` to `length`; returns (padded, valid mask of `length`)."""
    n = x.shape[pad_dim]
    if n > length:
        sl = [slice(None)] * x.ndim
        sl[pad_dim] = slice(0, length)
        return x[tuple(sl)], np.ones(length, bool)
    pad_width = [(0, 0)] * x.ndim
    pad_width[pad_dim] = (0, length - n)
    if mode == "zeros":
        padded = np.pad(x, pad_width)
    elif mode == "random_c":
        padded = np.pad(x, pad_width, mode="edge")
    else:
        raise ValueError(mode)
    mask = np.zeros(length, bool)
    mask[:n] = True
    return padded, mask


def pad_local_features(pred: dict, seq_l: int) -> dict:
    """Keypoints (with their scores, descriptors, scales and orientations)
    and lines (with their scores) padded to `seq_l`, with `keypoint_mask`
    and `line_mask`."""
    out = dict(pred)
    if "keypoints" in pred:
        out["keypoints"], out["keypoint_mask"] = pad_to_length(pred["keypoints"], seq_l)
        for key in ("keypoint_scores", "descriptors", "scales", "oris"):
            if key in pred:
                out[key], _ = pad_to_length(pred[key], seq_l)
    if "lines" in pred:
        out["lines"], out["line_mask"] = pad_to_length(pred["lines"], seq_l)
        if "line_scores" in pred:
            out["line_scores"], _ = pad_to_length(pred["line_scores"], seq_l)
    return out


class CacheLoader:
    default_conf = {
        "path": "???",  # a format string of the item's fields, e.g. exports/{method}/{scene}.h5
        "data_keys": ["keypoints", "keypoint_scores", "descriptors"],
        "scale": ["keypoints", "lines", "orig_lines"],
        "padding_length": None,
        "numeric_type": "float32",
        "collate": False,
    }

    def __init__(self, conf=None):
        self.conf = merge(Config(self.default_conf), conf or {})
        self._files: dict = {}

    def _file(self, path: str) -> H5File:
        if path not in self._files:
            p = Path(path)
            if not p.is_absolute():
                p = settings.DATA_PATH / path
            self._files[path] = H5File(p)
        return self._files[path]

    def __call__(self, data: dict) -> dict:
        """The features of the item `data` describes: its string and
        scalar fields fill the path (`scene`, ...), `name` is its group
        (the root without one), and optional `scales` (x, y) take the
        keypoints and lines into the processed image."""
        fields = {k: (v[0] if isinstance(v, (list, tuple)) else v) for k, v in data.items()
                  if isinstance(v, (str, list, tuple)) or np.isscalar(v)}
        path_keys = [t[1] for t in string.Formatter().parse(self.conf.path) if t[1] is not None]
        hfile = self._file(self.conf.path.format(**{k: fields[k] for k in path_keys}))
        name = fields.get("name", None)
        grp = hfile[str(name)] if name is not None else hfile
        pred = {}
        for k in self.conf.data_keys:
            if k in grp:
                arr = np.asarray(grp[k])
                if np.issubdtype(arr.dtype, np.floating):
                    arr = arr.astype(self.conf.numeric_type)
                pred[k] = arr
        scales = data.get("scales")
        if scales is not None:
            s = np.asarray(scales, np.float32).reshape(-1)[-2:]
            for pattern in self.conf.scale:
                for k in list(pred):
                    if k.startswith(pattern):
                        pred[k] = pred[k] * s.reshape(*([1] * (pred[k].ndim - 1)), 2)
        if self.conf.padding_length:
            pred = pad_local_features(pred, int(self.conf.padding_length))
        return pred

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files = {}
