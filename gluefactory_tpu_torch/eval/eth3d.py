"""ETH3D match precision-recall benchmark (counterpart of
`gluefactory_tpu/eval/eth3d.py`).

The depth ground truth (`depth_matcher`, 3 px positive, 5 px negative)
runs inside the pipeline's forward (`run_gt_in_forward`), on the device
the model runs on, so the export caches the predicted and the GT matches
together; the eval loop turns them into a precision-recall curve and its AP
over all pairs' points, and with `eval.eval_lines` over all pairs' lines
too (`superpoint+lsd+gluestick`, whose config turns on the line GT).

    python -m gluefactory_tpu_torch.eval.eth3d --conf superpoint+NN \\
        [--device cuda|cpu] [--overwrite] [--overwrite_eval]

reads `DATA_PATH/ETH3D_undistorted/` (`data/eth3d.py`) and writes under
`EVAL_PATH/eth3d/<tag>/` (`predictions.h5`, `results.h5`,
`summaries.json`, `conf.yaml`). The line keys are exported where the model
gives them.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..data import get_dataset
from ..data.hdf5 import H5File
from ..utils.export_predictions import load_prediction
from .eval_pipeline import EvalPipeline
from .megadepth1500 import main as _main
from .utils import aggregate_pr_results, get_tp_fp_pts


def eval_dataset(loader, pred_file, suffix: str = "") -> dict:
    """The PR curve and AP of the cached matches against the cached GT
    matches, every pair's matches ranked together by score; `suffix`
    "_lines" reads the line keys."""
    results = defaultdict(list)
    results["num_pos" + suffix] = 0
    prefix = "" if suffix == "" else "line_"
    with H5File(pred_file) as h5:
        for batch in loader:
            pred = load_prediction(h5, batch["name"][0])
            scores = pred[f"{prefix}matching_scores0"]
            order = np.argsort(scores)[::-1]
            tp, fp, scores, num_pos = get_tp_fp_pts(pred[f"{prefix}matches0"][order],
                                                    pred[f"gt_{prefix}matches0"][order],
                                                    scores[order])
            results["tp" + suffix].append(tp)
            results["fp" + suffix].append(fp)
            results["scores" + suffix].append(scores)
            results["num_pos" + suffix] += num_pos
    return aggregate_pr_results(results, suffix=suffix)


class ETH3DPipeline(EvalPipeline):
    default_conf = {
        "data": {
            "name": "eth3d",
            "batch_size": 1,
            "num_workers": 8,
        },
        "model": {
            "name": "two_view_pipeline",
            "run_gt_in_forward": True,
            "ground_truth": {
                "name": "depth_matcher",
                "use_points": True,
                "use_lines": False,
                "th_positive": 3.0,
                "th_negative": 5.0,
            },
        },
        "eval": {"plot_methods": [], "plot_line_methods": [], "eval_lines": False},
        "checkpoint": None,
        # items of one shape run as one batch of this size in the export
        # (None: each loader batch as it comes)
        "items_per_dispatch": None,
    }
    export_keys = [
        "keypoints0", "keypoints1",
        "matches0", "matching_scores0",
        "gt_matches0",
    ]
    optional_export_keys = [
        "lines0", "lines1",
        "line_matches0", "line_matching_scores0",
        "gt_line_matches0",
    ]

    @classmethod
    def get_dataloader(cls, data_conf=None):
        data_conf = data_conf or cls.default_conf["data"]
        return get_dataset("eth3d")(data_conf).get_data_loader("test")

    def run_eval(self, loader, pred_file):
        results = eval_dataset(loader, pred_file)
        if self.conf.eval.eval_lines:
            results.update(eval_dataset(loader, pred_file, suffix="_lines"))
        summaries = {k: v for k, v in results.items() if not isinstance(v, np.ndarray)}
        return summaries, {}, results


def main(argv=None):
    """The CLI; returns (summaries, figures, results)."""
    return _main(argv, ETH3DPipeline, "eth3d")


if __name__ == "__main__":
    main()
