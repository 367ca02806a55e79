"""View-dict helpers for the triplet pipeline (counterpart of the parts of
`gluefactory_tpu/utils/misc.py` it uses).

Per-view data lives under `view0` / `view1` / `view2`; a pair `idx` in
{"0to1", "0to2", "1to2"} is a two-view dict whose views and `T_` / `H_` /
`overlap_` entries are renamed to `0to1`; pairs stack along the batch axis
for one matcher pass and split back after it.
"""

from __future__ import annotations

import torch

from .tensor import map_tensor


def get_twoview_data(data: dict, idx: str) -> dict:
    """The two-view dict of pair `idx` (e.g. "0to2": view0 and view2)."""
    i, j = idx[0], idx[-1]
    out = {"view0": data[f"view{i}"], "view1": data[f"view{j}"]}
    for key in (f"T_{idx}", f"H_{idx}", f"overlap_{idx}"):
        if key in data:
            out[key.replace(idx, "0to1")] = data[key]
    return out


def map_multi(dicts: list):
    """Batch dicts of one structure concatenated along axis 0: tensors with
    `torch.cat`, cameras and poses with their `concatenate`, other leaves
    as lists."""
    out = {}
    for k, v in dicts[0].items():
        vals = [d[k] for d in dicts]
        if isinstance(v, dict):
            out[k] = map_multi(vals)
        elif torch.is_tensor(v):
            out[k] = torch.cat(vals, dim=0)
        elif hasattr(v, "map_tensors"):
            out[k] = type(v).concatenate(vals)
        else:
            out[k] = vals
    return out


def unstack_twoviews(pred: dict, batch_size: int, indices=("0to1", "0to2", "1to2")) -> dict:
    """Predictions of stacked pairs split back into {idx: pred}."""
    return {idx: map_tensor(pred, lambda x: x[n * batch_size:(n + 1) * batch_size])
            for n, idx in enumerate(indices)}
