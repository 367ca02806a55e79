"""Timing on the card for the profiling tools (the counterpart of the JAX
prototypes' `chain_time`): CUDA events around n launches after a warm-up."""

from __future__ import annotations

import subprocess

import torch

WARMUP = 3


def cuda_time_ms(fn, reps: int = 20, warmup: int = WARMUP) -> float:
    """Mean milliseconds of one call of `fn` over `reps` calls between two
    CUDA events, after `warmup` calls. Raises without a CUDA device: a CPU run
    has no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms: no CUDA device")
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps: int = 20, warmup: int = WARMUP) -> float:
    """Mean device milliseconds of one call of `fn`: the time of every kernel
    and copy it ran on the card (torch.profiler) over `reps` calls, after
    `warmup` calls. Unlike `cuda_time_ms`, host time between launches does
    not count, so a short kernel behind a Python wrapper is timed as the
    device runs it. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / reps


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
