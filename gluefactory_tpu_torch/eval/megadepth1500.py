"""MegaDepth-1500 relative-pose benchmark (counterpart of
`gluefactory_tpu/eval/megadepth1500.py`).

Loop 1 exports the matches at the original resolution; loop 2 rescales
them into the processed images' coordinates, computes the epipolar and
depth match metrics and the relative pose of each pair by the estimator at
each RANSAC threshold (a sweep of 0.5 ... 3.0 px when `ransac_th <= 0`),
then the pose AUC@5/10/20 degrees at the threshold with the best mAA.

    python -m gluefactory_tpu_torch.eval.megadepth1500 --conf superpoint+lightglue-official \\
        eval.estimator=xla_ransac [data.depth_format=png] [--device cuda|cpu] \\
        [--overwrite] [--overwrite_eval]

reads the posed-images layout under `DATA_PATH/megadepth1500/`
(`<scene>/{images,depths}/`, `views.txt`, `pairs.txt`) and writes under
`EVAL_PATH/megadepth1500/<tag>/`. Without `--device` it runs on `cuda` and
raises where there is none. `estimator=opencv` needs cv2;
`depth_format=h5` (the default) is read by `data/hdf5.py`, without h5py.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Iterable
from pathlib import Path
from pprint import pprint

import numpy as np

from ..data import get_dataset
from ..data.base_dataset import prepare_batch
from ..settings import EVAL_PATH
from ..data.hdf5 import H5File
from ..utils.tensor import map_tensor, rbd
from ..visualization.viz2d import plot_cumulative
from .eval_pipeline import EvalPipeline
from .hpatches import load_cached_prediction
from .io import check_device, get_eval_parser, parse_eval_args
from .utils import eval_matches_depth, eval_matches_epipolar, eval_poses, eval_relative_pose_robust

SWEEP = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]


class MegaDepth1500Pipeline(EvalPipeline):
    default_conf = {
        "data": {
            "name": "posed_images",
            "root": "megadepth1500",
            "image_dir": "{scene}/images",
            "depth_dir": "{scene}/depths",
            "views": "{scene}/views.txt",
            "view_groups": "{scene}/pairs.txt",
            "depth_format": "h5",
            "scene_list": None,
            "preprocessing": {
                "resize": 1600,
                "side": "long",
                "interpolation": "area",
                "antialias": False,
            },
            "num_workers": 8,
            "batch_size": 1,
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

    @classmethod
    def get_dataloader(cls, data_conf=None):
        data_conf = data_conf or cls.default_conf["data"]
        name = data_conf["name"] if isinstance(data_conf, dict) else data_conf.name
        return get_dataset(name)(data_conf).get_data_loader("test")

    def run_eval(self, loader, pred_file):
        conf = self.conf.eval
        if not isinstance(conf.ransac_th, Iterable):
            test_thresholds = [conf.ransac_th] if conf.ransac_th > 0 else SWEEP
        else:
            test_thresholds = list(conf.ransac_th)
        results = defaultdict(list)
        pose_results = defaultdict(lambda: defaultdict(list))
        with H5File(pred_file) as h5:
            for batch in loader:
                data_i = rbd(prepare_batch(batch, "cpu"))
                name = batch["name"][0]
                pred = load_cached_prediction(h5, name, map_tensor(batch, lambda t: np.asarray(t)[0]))
                results_i = eval_matches_epipolar(data_i, pred)
                if "depth" in batch.get("view0", {}):
                    results_i.update(eval_matches_depth(data_i, pred))
                for th in test_thresholds:
                    est_conf = {"estimator": conf.estimator, "ransac_th": th, "device": self.device}
                    for k, v in eval_relative_pose_robust(data_i, pred, est_conf).items():
                        pose_results[th][k].append(v)
                results_i["names"] = name
                for k, v in results_i.items():
                    results[k].append(v)

        summaries = {}
        for k, v in results.items():
            arr = np.array(v)
            if np.issubdtype(arr.dtype, np.number):
                summaries[f"m{k}"] = round(float(np.nanmedian(arr)), 3)
        best_pose_results, best_th = eval_poses(pose_results, auc_ths=[5, 10, 20],
                                                key="rel_pose_error", unit="°")
        results = {**results, **pose_results[best_th]}
        summaries = {**summaries, **best_pose_results}
        figures = {}
        try:
            figures["pose_recall"] = plot_cumulative({conf.estimator: results["rel_pose_error"]},
                                                     [0, 30], unit="°", title="Pose ")
        except ImportError:  # no matplotlib: no figure
            pass
        return summaries, figures, results


def main(argv=None, pipeline_cls=MegaDepth1500Pipeline, dataset_name: str = "megadepth1500"):
    """The CLI; returns (summaries, figures, results)."""
    args = get_eval_parser().parse_intermixed_args(argv)
    check_device(args.device)
    name, conf = parse_eval_args(dataset_name, args, "configs/", pipeline_cls.default_conf)
    experiment_dir = Path(EVAL_PATH, dataset_name, name)
    experiment_dir.mkdir(exist_ok=True, parents=True)
    pipeline = pipeline_cls(conf, device=args.device)
    s, f, r = pipeline.run(experiment_dir, overwrite=args.overwrite,
                           overwrite_eval=args.overwrite_eval)
    pprint(s)
    if args.plot:
        import matplotlib.pyplot as plt

        plt.show()
    return s, f, r


if __name__ == "__main__":
    main()
