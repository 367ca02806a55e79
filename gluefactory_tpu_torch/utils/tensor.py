"""Batch-tree helpers (counterpart of `gluefactory_tpu/utils/tensor.py`).

Batches are nested dicts of tensors, with strings and lists of strings
passed through as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def map_tensor(input_, func):
    """Apply `func` to every tensor or array leaf of a nested dict / list /
    tuple, and to the tensors of a `Camera` or `Pose` (`map_tensors`);
    strings, None and other leaves pass through unchanged."""
    if hasattr(input_, "map_tensors"):
        return input_.map_tensors(func)
    if isinstance(input_, dict):
        return {k: map_tensor(v, func) for k, v in input_.items()}
    if isinstance(input_, (list, tuple)):
        return type(input_)(map_tensor(v, func) for v in input_)
    if is_array(input_):
        return func(input_)
    return input_


def to_numpy(batch):
    """Every tensor leaf as a numpy array on the host, from any device
    (bfloat16 as float32); numpy arrays pass through."""

    def _np(x):
        if not torch.is_tensor(x):
            return np.asarray(x)
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()

    return map_tensor(batch, _np)


def batch_to_device(batch, device, non_blocking: bool = True):
    """Every leaf to `device` as a tensor. A tensor in pinned host memory
    (the loader pins batches for a CUDA device) is copied asynchronously
    with `non_blocking`; numpy arrays are converted first."""

    def _put(x):
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        return t.to(device, non_blocking=non_blocking and t.is_pinned())

    return map_tensor(batch, _put)


def rbd(data: dict) -> dict:
    """Remove the batch dimension of every leaf."""
    return map_tensor(data, lambda x: x[0] if x.ndim > 0 else x)


def iter_leaves(d: dict):
    for v in d.values():
        if isinstance(v, dict):
            yield from iter_leaves(v)
        elif is_array(v):
            yield v


def index_batch(tensor_dict: dict):
    """Iterate over the items of a batched dict."""
    batch_size = len(next(iter_leaves(tensor_dict)))
    for i in range(batch_size):
        yield map_tensor(tensor_dict, lambda t: t[i])
