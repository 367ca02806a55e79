"""Export model predictions to a cache (counterpart of
`gluefactory_tpu/utils/export_predictions.py`).

Loop 1 of the eval protocol: run the model over a dataset, bring keypoints
and lines back to the original resolution, and write one group per item.
Masked (padded) keypoints and lines are trimmed before writing, with the
match indices remapped, so the cache holds exactly the valid sets.

The output is an HDF5 file as the JAX package writes it, one group per
item (a name with "/" as nested groups), written by `utils/hdf5_write.py`
(no h5py) and read back by `data/hdf5.py`: the eval caches
(`predictions.h5`) and the feature caches that `models/cache_loader.py`
reads. It streams item by item, so nothing accumulates in memory. A name
written before gets the suffix `_<n>`, n the number of items written so
far, as the JAX package's HDF5 groups do.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import logger
from ..data.hdf5 import H5File, H5Group
from .hdf5_write import H5Writer
from .tensor import map_tensor


def unscale_keypoints(pred: dict, data_i: dict) -> dict:
    """Keypoints and lines from processed to original resolution, by each
    view's `scales`."""
    out = dict(pred)
    for i in ("0", "1", ""):
        view = data_i.get(f"view{i}", data_i if i == "" else {})
        scales = view.get("scales")
        if scales is None:
            continue
        s = np.asarray(scales)
        for key in (f"keypoints{i}", f"lines{i}", f"orig_lines{i}"):
            if key in out:
                out[key] = out[key] / s.reshape(*([1] * (out[key].ndim - 1)), 2)
    return out


def _index_remap(mask: np.ndarray) -> np.ndarray:
    """old index -> new index after dropping masked entries (-1 for dropped)."""
    remap = np.full(len(mask), -1, np.int64)
    remap[mask] = np.arange(int(mask.sum()))
    return remap


def _remap_matches(matches: np.ndarray, remap_other: np.ndarray) -> np.ndarray:
    """Match targets in the other view's trimmed indexing; -1 (unmatched)
    and -2 (ignored) pass through."""
    out = matches.copy()
    valid = matches >= 0
    out[valid] = remap_other[matches[valid]]
    return out


def _trim(out: dict, keys, mask) -> None:
    for key in keys:
        if key in out and np.asarray(out[key]).shape[:1] == mask.shape:
            out[key] = np.asarray(out[key])[mask]


def trim_masked(pred: dict) -> dict:
    """Drop the padded entries by the keypoint and line masks (removing the
    masks) and remap the cross-view match indices to stay consistent."""
    out = dict(pred)
    mask_u = out.pop("keypoint_mask", None)
    if mask_u is not None:
        _trim(out, ("keypoints", "keypoint_scores", "descriptors", "scales", "oris"),
              np.asarray(mask_u).astype(bool))
    lmask_u = out.pop("line_mask", None)
    if lmask_u is not None:
        _trim(out, ("lines", "line_scores", "orig_lines"), np.asarray(lmask_u).astype(bool))
    masks = {i: out.pop(f"keypoint_mask{i}", None) for i in "01"}
    lmasks = {i: out.pop(f"line_mask{i}", None) for i in "01"}
    masks = {i: None if m is None else np.asarray(m).astype(bool) for i, m in masks.items()}
    lmasks = {i: None if m is None else np.asarray(m).astype(bool) for i, m in lmasks.items()}
    for i, other in (("0", "1"), ("1", "0")):
        mask = masks[i]
        if mask is None:
            continue
        if masks[other] is not None:
            remap_other = _index_remap(masks[other])
            for key in (f"matches{i}", f"gt_matches{i}"):
                if key in out:
                    out[key] = _remap_matches(np.asarray(out[key]), remap_other)
        _trim(out, (f"keypoints{i}", f"keypoint_scores{i}", f"descriptors{i}", f"matches{i}",
                    f"gt_matches{i}", f"matching_scores{i}", f"scales{i}", f"oris{i}"), mask)
        lmask = lmasks[i]
        if lmask is not None:
            if lmasks[other] is not None:
                remap_lother = _index_remap(lmasks[other])
                for key in (f"line_matches{i}", f"gt_line_matches{i}"):
                    if key in out:
                        out[key] = _remap_matches(np.asarray(out[key]), remap_lother)
            _trim(out, (f"lines{i}", f"line_scores{i}", f"orig_lines{i}", f"line_matches{i}",
                        f"gt_line_matches{i}", f"line_matching_scores{i}"), lmask)
    return out


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _index_tree(tree, b: int):
    """The b-th item of every leaf (arrays and lists, e.g. `name`)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, b) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, list, tuple)):
        return tree[b]
    return tree


def _split_items(batch: dict) -> list:
    """A collated batch (leading dim B) as B unbatched item dicts of numpy
    arrays."""
    as_np = map_tensor(batch, _to_numpy)
    sizes = [len(v) for v in as_np.values() if isinstance(v, (np.ndarray, list))]
    bsz = sizes[0] if sizes else 1
    return [_index_tree(as_np, b) for b in range(bsz)]


def _group_collate(items: list):
    """Unbatched item dicts of one shape signature as one batch."""
    elem = items[0]
    if isinstance(elem, dict):
        return {k: _group_collate([it[k] for it in items]) for k in elem}
    if isinstance(elem, (str, bytes)):
        return list(items)
    if isinstance(elem, np.ndarray) or np.isscalar(elem):
        return np.stack([np.asarray(it) for it in items], axis=0)
    return list(items)


def _shape_signature(item) -> tuple:
    """Hashable signature of every array leaf's shape and dtype: only items
    of one signature are grouped, so no image is padded to another's size."""
    if isinstance(item, dict):
        return tuple((k, _shape_signature(v)) for k, v in sorted(item.items()))
    if isinstance(item, np.ndarray):
        return (item.shape, str(item.dtype))
    return type(item).__name__


class PredictionWriter:
    """Items written one by one as groups `<name>` of one HDF5 file (a name
    with "/" as nested groups), each array a dataset."""

    def __init__(self, path: Path):
        self.file = H5Writer(path)
        self.names: set = set()

    def write(self, name: str, arrays: dict) -> None:
        try:
            grp = self.file.create_group(name)
        except ValueError:
            name = f"{name}_{len(self.names)}"
            grp = self.file.create_group(name)
        self.names.add(name)
        for k, v in arrays.items():
            if isinstance(v, np.ndarray):
                grp.create_dataset(k, data=v)

    def close(self) -> None:
        self.file.close()


def load_prediction(h5: H5File, name: str) -> dict:
    """One item's arrays (the datasets of its group `name`) from a cache
    open as an `H5File`, read from disk now."""
    group = h5[name]
    return {k: group[k] for k in group.keys()}


def load_predictions(path) -> dict:
    """Every item of the cache at `path`: {name: arrays}, each group that
    holds datasets an item (a name with "/" for nested groups)."""
    out: dict = {}
    with H5File(path) as h5:
        stack = [("", h5["/"])]
        while stack:
            name, group = stack.pop()
            arrays = {}
            for k in group.keys():
                member = group[k]
                if isinstance(member, H5Group):
                    stack.append((f"{name}/{k}".lstrip("/"), member))
                else:
                    arrays[k] = member
            if arrays:
                out[name] = arrays
    return out


def export_predictions(loader, apply_fn, output_file: Path, as_half: bool = False,
                       keys: str | list = "*", callback_fn=None, trim_masks: bool = True,
                       items_per_dispatch: int | None = None) -> Path:
    """Run `apply_fn(batch) -> pred (dict of numpy arrays, batched)` over the
    loader and cache the results; `apply_fn` owns the device.

    `items_per_dispatch` groups that many items of one shape signature into
    one batch per forward. A bucket left over at the end is filled up by
    repeating its last item, so every forward has the same batch size, and
    the repeats' outputs are dropped. None runs each loader batch as it
    comes. Each item's outputs are unbatched, filtered to `keys`, passed to
    `callback_fn(pred, item)` (its keys added under the model's), trimmed,
    un-scaled, and with `as_half` their float32 arrays stored as float16.
    """
    output_file = Path(output_file)
    output_file.parent.mkdir(exist_ok=True, parents=True)
    buckets: dict = {}
    writer = PredictionWriter(output_file)

    def flush(group):
        n_real = len(group)
        if n_real == 0:
            return
        pad_to = items_per_dispatch or n_real
        pred = apply_fn(_group_collate(group + [group[-1]] * (pad_to - n_real)))
        for b in range(n_real):
            item = group[b]
            pred_b = map_tensor(pred, lambda x: x[b])
            data_b = {k: v for k, v in item.items() if k.startswith("view") or k == "scales"}
            if keys != "*":
                pred_b = {k: v for k, v in pred_b.items() if k in keys}
            if callback_fn is not None:
                pred_b = {**callback_fn(pred_b, item), **pred_b}
            if trim_masks:
                pred_b = trim_masked(pred_b)
            pred_b = unscale_keypoints(pred_b, data_b)
            if as_half:
                pred_b = {k: v.astype(np.float16) if isinstance(v, np.ndarray)
                          and v.dtype == np.float32 else v for k, v in pred_b.items()}
            if len(writer.names) % 50 == 0:
                logger.info("Exported %d items", len(writer.names))
            writer.write(str(item.get("name", len(writer.names))), pred_b)

    try:
        for batch in loader:
            items = _split_items(batch)
            if items_per_dispatch is None:
                flush(items)
                continue
            for item in items:
                bucket = buckets.setdefault(_shape_signature(item), [])
                bucket.append(item)
                if len(bucket) >= items_per_dispatch:
                    flush(bucket)
                    bucket.clear()
        for bucket in buckets.values():
            flush(bucket)
    finally:
        writer.close()
    return output_file
