"""Streaming metric accumulators and seeding (counterpart of
`gluefactory_tpu/utils/tools.py`). Accumulators run on the host over numpy
values: the trainer reads losses and metrics from the device only where it
logs or evaluates."""

from __future__ import annotations

import contextlib
import random
from collections.abc import Iterable

import numpy as np
import torch


def _values(values) -> np.ndarray:
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(values, dtype=np.float64))


class AverageMetric:
    """Mean of every value seen, NaNs left out."""

    def __init__(self, elements=None):
        self._sum = 0.0
        self._num = 0
        if elements is not None:
            self.update(elements)

    def update(self, values):
        values = _values(values)
        mask = ~np.isnan(values)
        self._sum += float(values[mask].sum())
        self._num += int(mask.sum())

    def compute(self):
        return np.nan if self._num == 0 else self._sum / self._num


class MedianMetric:
    def __init__(self, elements=None):
        self._elements = []
        if elements is not None:
            self.update(elements)

    def update(self, values):
        self._elements.extend(_values(values).tolist())

    def compute(self):
        arr = np.asarray(self._elements)
        arr = arr[~np.isnan(arr)]
        return np.nan if arr.size == 0 else float(np.median(arr))


class RecallMetric:
    """Share of values strictly below threshold(s); NaNs count in the
    denominator."""

    def __init__(self, ths, elements=None):
        self.ths = ths
        self._elements = []
        if elements is not None:
            self.update(elements)

    def update(self, values):
        self._elements.extend(_values(values).tolist())

    def compute(self):
        if isinstance(self.ths, Iterable):
            return [self._compute(th) for th in self.ths]
        return self._compute(self.ths)

    def _compute(self, th):
        arr = np.asarray(self._elements)
        if arr.size == 0:
            return np.nan
        return float((arr < th).sum() / arr.size)


def cal_error_auc(errors, thresholds) -> list:
    """Error-recall AUC by the trapezoid rule up to each threshold, each
    rounded to 4 decimals as the reference reports them."""
    errors = np.sort(np.asarray(errors, dtype=np.float64))
    if errors.size == 0:
        return [0.0] * len(thresholds)
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(float(np.round(np.trapezoid(r, x=e) / t, 4)))
    return aucs


class AUCMetric:
    """AUC at each threshold of every finite-or-infinite value seen, NaNs
    left out."""

    def __init__(self, thresholds, elements=None):
        self._elements = [] if elements is None else list(np.atleast_1d(elements))
        self.thresholds = thresholds if isinstance(thresholds, list) else [thresholds]

    def update(self, values):
        self._elements.extend(_values(values).tolist())

    def compute(self):
        arr = np.asarray(self._elements, dtype=np.float64)
        arr = arr[~np.isnan(arr)]
        if arr.size == 0:
            return np.nan
        return cal_error_auc(arr, self.thresholds)


class PRMetric:
    """Accumulates (label, prediction) pairs for PR curves."""

    def __init__(self):
        self.labels = []
        self.predictions = []

    def update(self, labels, predictions, mask=None):
        labels, predictions = (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                               for x in (labels, predictions))
        if mask is not None:
            mask = (mask.detach().cpu().numpy() if torch.is_tensor(mask) else np.asarray(mask)).astype(bool)
            labels, predictions = labels[mask], predictions[mask]
        self.labels.append(labels.reshape(-1))
        self.predictions.append(predictions.reshape(-1))

    def compute(self):
        return np.concatenate(self.labels), np.concatenate(self.predictions)

    def reset(self):
        self.labels, self.predictions = [], []


def set_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed the host RNGs (python, numpy, torch's global one) and return a
    fresh `torch.Generator` on `device` seeded with `seed`: the trainer
    draws its randomness from explicit generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


@contextlib.contextmanager
def fork_rng(seed=None):
    """Run a block with the host RNGs (python, numpy, torch's CPU one) forked,
    optionally seeded, and restore their state after it."""
    state = get_random_state()
    try:
        if seed is not None:
            random.seed(seed)
            np.random.seed(seed)
            torch.manual_seed(seed)
        yield
    finally:
        set_random_state(state)


def get_random_state() -> dict:
    """The host RNGs' state (python, numpy, torch's CPU one)."""
    return {"python": random.getstate(), "numpy": np.random.get_state(),
            "torch": torch.random.get_rng_state()}


def set_random_state(state: dict) -> None:
    random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    torch.random.set_rng_state(state["torch"])
