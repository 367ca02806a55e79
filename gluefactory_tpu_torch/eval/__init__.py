"""Benchmarks (counterpart of `gluefactory_tpu/eval/__init__.py`):
`hpatches`, `megadepth1500`, `scannet1500`, `eth3d` and `zeb`."""

from __future__ import annotations

from pathlib import Path

def get_benchmark(benchmark: str):
    if benchmark == "hpatches":
        from .hpatches import HPatchesPipeline

        return HPatchesPipeline
    if benchmark == "megadepth1500":
        from .megadepth1500 import MegaDepth1500Pipeline

        return MegaDepth1500Pipeline
    if benchmark == "scannet1500":
        from .scannet1500 import ScanNet1500Pipeline

        return ScanNet1500Pipeline
    if benchmark == "eth3d":
        from .eth3d import ETH3DPipeline

        return ETH3DPipeline
    if benchmark == "zeb":
        from .zeb import ZEBPipeline

        return ZEBPipeline
    raise ValueError(f"unknown benchmark {benchmark}")


def run_benchmark(benchmark: str, eval_conf, experiment_dir, model=None, device="cuda"):
    """A benchmark on `model` (in memory) into `experiment_dir`, cache and
    eval overwritten: the trainer's per-epoch hook."""
    bm = get_benchmark(benchmark)(eval_conf, device=device)
    experiment_dir = Path(experiment_dir)
    experiment_dir.mkdir(exist_ok=True, parents=True)
    return bm.run(experiment_dir, model=model, overwrite=True, overwrite_eval=True)
