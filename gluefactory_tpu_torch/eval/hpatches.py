"""HPatches homography-estimation benchmark (counterpart of
`gluefactory_tpu/eval/hpatches.py`).

Loop 1 exports the matches at the original resolution; loop 2 rescales them
into the processed images' coordinates, computes match precision, the DLT
and the RANSAC homography errors, and the AUC@1/3/5 px summaries, the RANSAC
threshold chosen by mAA where several are swept.

    python -m gluefactory_tpu_torch.eval.hpatches --conf superpoint+lightglue-official \\
        eval.estimator=xla_ransac [--device cuda|cpu] [--overwrite] [--overwrite_eval]

writes under `EVAL_PATH/hpatches/<tag>/`. Without `--device` it runs on
`cuda` and raises where there is none.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Iterable
from pathlib import Path
from pprint import pprint

import numpy as np

from ..data import get_dataset
from ..settings import EVAL_PATH
from ..utils.export_predictions import load_prediction, prediction_keys
from ..utils.tensor import map_tensor
from ..utils.tools import AUCMetric
from ..visualization.viz2d import plot_cumulative
from .eval_pipeline import EvalPipeline
from .io import check_device, get_eval_parser, parse_eval_args
from .utils import eval_homography_dlt, eval_homography_robust, eval_matches_homography, eval_poses


def load_cached_prediction(npz, keys: dict, name: str, data_i: dict) -> dict:
    """A cached prediction with its keypoints and lines rescaled into the
    processed images' coordinates by each view's `scales`."""
    pred = load_prediction(npz, keys, name)
    for i in ("0", "1"):
        scales = data_i.get(f"view{i}", {}).get("scales")
        if scales is None:
            continue
        for key in (f"keypoints{i}", f"lines{i}", f"orig_lines{i}"):
            if key in pred:
                pred[key] = pred[key] * np.asarray(scales).reshape(*([1] * (pred[key].ndim - 1)), 2)
    return pred


class HPatchesPipeline(EvalPipeline):
    default_conf = {
        "data": {
            "batch_size": 1,
            "name": "hpatches",
            "num_workers": 8,
            "preprocessing": {"resize": 480, "side": "short"},
        },
        "model": {"ground_truth": {"name": None}},
        "eval": {
            "estimator": "opencv",  # opencv | xla_ransac
            "ransac_th": 0.5,  # <= 0 sweeps thresholds, the best by mAA
        },
        "checkpoint": None,
        # items of one shape run as one batch of this size in the export
        # (None: each loader batch as it comes)
        "items_per_dispatch": None,
    }
    export_keys = [
        "keypoints0", "keypoints1",
        "keypoint_scores0", "keypoint_scores1",
        "matches0", "matches1",
        "matching_scores0", "matching_scores1",
    ]
    optional_export_keys = [
        "lines0", "lines1", "orig_lines0", "orig_lines1",
        "line_matches0", "line_matches1",
        "line_matching_scores0", "line_matching_scores1",
    ]

    @classmethod
    def get_dataloader(cls, data_conf=None):
        data_conf = data_conf or cls.default_conf["data"]
        return get_dataset("hpatches")(data_conf).get_data_loader("test")

    def run_eval(self, loader, pred_file):
        conf = self.conf.eval
        if not isinstance(conf.ransac_th, Iterable):
            test_thresholds = [conf.ransac_th] if conf.ransac_th > 0 else [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
        else:
            test_thresholds = list(conf.ransac_th)
        results = defaultdict(list)
        pose_results = defaultdict(lambda: defaultdict(list))
        with np.load(pred_file, allow_pickle=False) as npz:
            keys = prediction_keys(npz)
            for batch in loader:
                data_i = map_tensor(batch, lambda t: np.asarray(t)[0])
                name = batch["name"][0]
                pred = load_cached_prediction(npz, keys, name, data_i)
                if "keypoints0" in pred:
                    results_i = {**eval_matches_homography(data_i, pred),
                                 **eval_homography_dlt(data_i, pred)}
                else:
                    results_i = {}
                for th in test_thresholds:
                    est_conf = {"estimator": conf.estimator, "ransac_th": th, "device": self.device}
                    for k, v in eval_homography_robust(data_i, pred, est_conf).items():
                        pose_results[th][k].append(v)
                results_i["names"] = name
                results_i["scenes"] = batch["scene"][0]
                for k, v in results_i.items():
                    results[k].append(v)

        summaries = {}
        for k, v in results.items():
            arr = np.array(v)
            if np.issubdtype(arr.dtype, np.number):
                summaries[f"m{k}"] = round(float(np.median(arr)), 3)
        auc_ths = [1, 3, 5]
        best_pose_results, best_th = eval_poses(pose_results, auc_ths=auc_ths,
                                                key="H_error_ransac", unit="px")
        if "H_error_dlt" in results:
            # NaN for every threshold when no pair had a DLT fit (the JAX
            # package raises TypeError there)
            dlt_aucs = AUCMetric(auc_ths, results["H_error_dlt"]).compute()
            for j, ath in enumerate(auc_ths):
                summaries[f"H_error_dlt@{ath}px"] = np.nan if np.isscalar(dlt_aucs) else dlt_aucs[j]
        results = {**results, **pose_results[best_th]}
        summaries = {**summaries, **best_pose_results}
        figures = {}
        try:
            figures["homography_recall"] = plot_cumulative(
                {"DLT": results["H_error_dlt"], conf.estimator: results["H_error_ransac"]},
                [0, 10], unit="px", title="Homography ")
        except ImportError:  # no matplotlib: no figure
            pass
        return summaries, figures, results


def main(argv=None):
    """The CLI; returns (summaries, figures, results)."""
    dataset_name = Path(__file__).stem
    parser = get_eval_parser()
    args = parser.parse_intermixed_args(argv)
    check_device(args.device)
    name, conf = parse_eval_args(dataset_name, args, "configs/", HPatchesPipeline.default_conf)
    experiment_dir = Path(EVAL_PATH, dataset_name, name)
    experiment_dir.mkdir(exist_ok=True, parents=True)
    pipeline = HPatchesPipeline(conf, device=args.device)
    s, f, r = pipeline.run(experiment_dir, overwrite=args.overwrite,
                           overwrite_eval=args.overwrite_eval)
    pprint(s)
    if args.plot:
        import matplotlib.pyplot as plt

        plt.show()
    return s, f, r


if __name__ == "__main__":
    main()
