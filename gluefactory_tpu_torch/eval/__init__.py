"""Benchmarks (counterpart of `gluefactory_tpu/eval/__init__.py`). Ported:
`hpatches`. MegaDepth-1500, ScanNet-1500, ETH3D and ZEB need the camera
geometry, the relative-pose solvers and depth, which are not ported yet."""

from __future__ import annotations

from pathlib import Path

_WAITING = ("megadepth1500", "scannet1500", "eth3d", "zeb")


def get_benchmark(benchmark: str):
    if benchmark == "hpatches":
        from .hpatches import HPatchesPipeline

        return HPatchesPipeline
    if benchmark in _WAITING:
        raise NotImplementedError(
            f"benchmark {benchmark} is not ported yet: it needs the camera geometry "
            "(geometry/wrappers.py), the relative-pose solvers and depth (ROADMAP queue 5)")
    raise ValueError(f"unknown benchmark {benchmark}")


def run_benchmark(benchmark: str, eval_conf, experiment_dir, model=None, device="cuda"):
    """A benchmark on `model` (in memory) into `experiment_dir`, cache and
    eval overwritten: the trainer's per-epoch hook."""
    bm = get_benchmark(benchmark)(eval_conf, device=device)
    experiment_dir = Path(experiment_dir)
    experiment_dir.mkdir(exist_ok=True, parents=True)
    return bm.run(experiment_dir, model=model, overwrite=True, overwrite_eval=True)
