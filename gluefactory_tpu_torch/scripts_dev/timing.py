"""Timing on the card for the profiling tools (the counterpart of the JAX
prototypes' `chain_time`): CUDA events around n launches after a warm-up,
with the host's time between launches (`cuda_time_ms`) or without it
(`device_time_ms`)."""

from __future__ import annotations

import subprocess

import torch

WARMUP = 3
# device_time_ms: the first sleep (~10 ms at 2 GHz) and how often it is
# quadrupled before giving up (the last is ~2.6 s)
SLEEP_CYCLES = 20_000_000
SLEEP_TRIES = 5


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
    """Mean device milliseconds of one call of `fn`: CUDA events around
    `reps` calls that the host queued while the device was still busy with a
    sleep kernel, so the device runs them back to back. Unlike
    `cuda_time_ms`, host time between launches does not count, so a short
    kernel behind a Python wrapper is timed as the device runs it. The sleep
    grows until the host queues every call before the device reaches the
    first; raises if `fn` blocks the host on the device, or without a CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms: no CUDA device")
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = SLEEP_CYCLES
    for _ in range(SLEEP_TRIES):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ahead = not start.query()  # the device had not reached the first call
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("device_time_ms: the device caught up with the host; "
                       "does the call wait for the device?")


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
