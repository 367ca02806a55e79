"""ScanNet-1500 relative-pose benchmark (counterpart of
`gluefactory_tpu/eval/scannet1500.py`): MegaDepth-1500's loops and metrics
on calibrated image pairs without depth.

    python -m gluefactory_tpu_torch.eval.scannet1500 --conf superpoint+lightglue-official \\
        eval.estimator=xla_ransac [--device cuda|cpu] [--overwrite] [--overwrite_eval]

reads `DATA_PATH/scannet1500/pairs_calibrated.txt` (`name0 name1 K0(9)
K1(9) T_0to1(12|16)` a line, the names relative to `DATA_PATH/scannet1500/`)
and writes under `EVAL_PATH/scannet1500/<tag>/`.
"""

from __future__ import annotations

from .megadepth1500 import MegaDepth1500Pipeline, main as _main


class ScanNet1500Pipeline(MegaDepth1500Pipeline):
    default_conf = {
        "data": {
            "name": "image_pairs",
            "pairs": "scannet1500/pairs_calibrated.txt",
            "root": "scannet1500",
            "extra_data": "relative_pose",
            "preprocessing": {"resize": 640, "side": "long"},
            "num_workers": 8,
            "batch_size": 1,
        },
        "model": {"ground_truth": {"name": None}},
        "eval": {"estimator": "opencv", "ransac_th": 0.5},
        "checkpoint": None,
    }


def main(argv=None):
    """The CLI; returns (summaries, figures, results)."""
    return _main(argv, ScanNet1500Pipeline, "scannet1500")


if __name__ == "__main__":
    main()
