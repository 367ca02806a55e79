"""ZEB zero-shot relative-pose benchmark (counterpart of
`gluefactory_tpu/eval/zeb.py`): the GIM cross-domain pair lists
(`data/zeb.py`) through ScanNet-1500's loops and metrics.

    python -m gluefactory_tpu_torch.eval.zeb --conf superpoint+superglue-official \\
        eval.estimator=xla_ransac [--device cuda|cpu] [--overwrite] [--overwrite_eval]

reads `DATA_PATH/zeb/<scene>/` and writes under `EVAL_PATH/zeb/<tag>/`.
"""

from __future__ import annotations

from .megadepth1500 import main as _main
from .scannet1500 import ScanNet1500Pipeline


class ZEBPipeline(ScanNet1500Pipeline):
    default_conf = {
        "data": {
            "name": "zeb",
            "preprocessing": {"resize": 1600, "side": "long"},
            "num_workers": 8,
            "batch_size": 1,
        },
        "model": {"ground_truth": {"name": None}},
        "eval": {"estimator": "opencv", "ransac_th": 0.5},
        "checkpoint": None,
    }


def main(argv=None):
    """The CLI; returns (summaries, figures, results)."""
    return _main(argv, ZEBPipeline, "zeb")


if __name__ == "__main__":
    main()
