"""The results inspector (counterpart of `gluefactory_tpu/eval/inspect.py`):
the per-item metrics of one or more eval experiments in a scatter; a
click opens the pair's two-view frame with every experiment's prediction.

    python -m gluefactory_tpu_torch.eval.inspect <benchmark> <experiment> [more ...]
        [--x METRIC] [--y METRIC] [--diff]

Reads `EVAL_PATH/<benchmark>/<experiment>/`: `results.h5` and
`summaries.json` (`load_eval`) and `predictions.h5`, through the port's
HDF5 reader (`data/hdf5.py`). `load_experiments` does the reading and
needs no matplotlib; `main` draws (matplotlib and a display).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import settings
from ..data.hdf5 import H5File
from . import get_benchmark
from .eval_pipeline import load_eval


def prediction_loader(pred_file: Path):
    """name -> {key: numpy array}: one item's group of `predictions.h5`.
    The file stays open for the loader's life."""
    hfile = H5File(pred_file)

    def load(name):
        grp = hfile[str(name)]
        return {k: grp[k] for k in grp.keys()}

    return load


def load_experiments(benchmark: str, experiments: list, eval_path=None) -> tuple[dict, dict]:
    """({experiment: per-item results}, {experiment: prediction loader})
    of each experiment under `eval_path/benchmark` (EVAL_PATH by default)."""
    output_dir = Path(settings.EVAL_PATH if eval_path is None else eval_path, benchmark)
    results, predictions = {}, {}
    for exp in experiments:
        _, results[exp] = load_eval(output_dir / exp)
        predictions[exp] = prediction_loader(output_dir / exp / "predictions.h5")
    return results, predictions


def main(argv=None):
    import matplotlib.pyplot as plt

    from ..visualization.global_frame import GlobalFrame
    from ..visualization.two_view_frame import TwoViewFrame

    parser = argparse.ArgumentParser()
    parser.add_argument("benchmark", type=str)
    parser.add_argument("experiments", type=str, nargs="+")
    parser.add_argument("--x", type=str, default=None)
    parser.add_argument("--y", type=str, default=None)
    parser.add_argument("--diff", action="store_true",
                        help="plot y as the per-item difference from the first experiment")
    args = parser.parse_args(argv)
    results, predictions = load_experiments(args.benchmark, args.experiments)
    loader = get_benchmark(args.benchmark).get_dataloader()
    frame = GlobalFrame({"x": args.x, "y": args.y, "diff": args.diff}, results, loader,
                        predictions, child_frame=TwoViewFrame)
    plt.show()
    return frame


if __name__ == "__main__":
    main()
