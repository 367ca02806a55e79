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


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
