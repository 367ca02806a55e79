"""Model latency benchmarking (counterpart of
`gluefactory_tpu/utils/benchmark.py`): `benchmark(fn, inputs)` times
`fn(*inputs)` and returns {"mean": ms, "std": ms, "reps"}.

On a CUDA device each call is timed by a pair of CUDA events around it,
read after a synchronize (the device's time from the first launch to the
last, the host's launch gaps included); on the CPU by `perf_counter`. The
device is that of the first tensor among the inputs, else `device`.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _first_device(inputs) -> torch.device | None:
    for x in inputs:
        if torch.is_tensor(x):
            return x.device
        if isinstance(x, dict):
            found = _first_device(list(x.values()))
            if found is not None:
                return found
        if isinstance(x, (list, tuple)):
            found = _first_device(x)
            if found is not None:
                return found
    return None


def benchmark(fn, inputs, warmup: int = 10, reps: int = 100, device=None) -> dict:
    """Time `fn(*inputs)` `reps` times after `warmup` calls; mean and std in
    milliseconds."""
    device = torch.device(device) if device is not None else (_first_device(inputs) or torch.device("cpu"))
    for _ in range(warmup):
        fn(*inputs)
    times = []
    if device.type == "cuda":
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda.synchronize(device)
        for start, end in events:
            start.record()
            fn(*inputs)
            end.record()
        torch.cuda.synchronize(device)
        times = [start.elapsed_time(end) for start, end in events]
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*inputs)
            times.append((time.perf_counter() - t0) * 1000)
    times = np.asarray(times)
    return {"mean": float(times.mean()), "std": float(times.std()), "reps": reps}
