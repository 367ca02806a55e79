"""The two-loop evaluation protocol (counterpart of
`gluefactory_tpu/eval/eval_pipeline.py`).

Loop 1, `get_predictions`: export the model's outputs to `predictions.h5`,
one HDF5 group an item as the JAX package writes it (`export_keys` and,
where the model gives them, `optional_export_keys`).
Loop 2, `run_eval`: read the cache and compute the metrics into
`results.npz` (the per-pair results) and `summaries.json`, with the figures
as PNG files. A conf whose `model` changed since the last run needs
`overwrite`, one whose `eval` changed `overwrite` or `overwrite_eval`.

The pipelines run on `device` (`cuda` unless the caller asks for the CPU):
the export's forward and the device RANSAC estimator.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .. import logger
from ..core.config import Config, from_yaml, merge
from ..utils.export_predictions import export_predictions
from .io import load_model, make_apply_fn


def load_eval(dir_: Path):
    """(summaries, results) of an eval directory."""
    dir_ = Path(dir_)
    with np.load(dir_ / "results.npz", allow_pickle=False) as npz:
        results = {k: npz[k] for k in npz.files if npz[k].ndim < 3}
    with open(dir_ / "summaries.json") as f:
        summaries = json.load(f)
    return summaries, results


def save_eval(dir_: Path, summaries: dict, figures: dict, results: dict) -> None:
    dir_ = Path(dir_)
    np.savez(dir_ / "results.npz", **{k: np.asarray(v) for k, v in results.items()})
    s = {k: float(v) if np.isscalar(v) and not isinstance(v, str) else v
         for k, v in summaries.items()}
    with open(dir_ / "summaries.json", "w") as f:
        json.dump(s, f, indent=4, default=str)
    for name, fig in (figures or {}).items():
        fig.savefig(dir_ / f"{name}.png")


def exists_eval(dir_: Path) -> bool:
    dir_ = Path(dir_)
    return (dir_ / "results.npz").exists() and (dir_ / "summaries.json").exists()


class EvalPipeline:
    default_conf: dict = {}
    export_keys: list = []
    optional_export_keys: list = []

    def __init__(self, conf=None, device: str = "cuda"):
        self.default_conf = Config(self.default_conf)
        self.conf = merge(self.default_conf, conf or {})
        self.device = device
        self._init(self.conf)

    def _init(self, conf):
        pass

    @classmethod
    def get_dataloader(cls, data_conf=None):
        raise NotImplementedError

    def get_predictions(self, experiment_dir, model=None, overwrite=False):
        """`predictions.h5` of `experiment_dir`, exported first (the export
        and optional keys, masked entries trimmed) unless it exists and is
        not to be overwritten; `model` in memory, else the conf's."""
        pred_file = Path(experiment_dir) / "predictions.h5"
        if not pred_file.exists() or overwrite:
            if model is None:
                model = load_model(self.conf.model, self.conf.get("checkpoint"), self.device)
            export_predictions(self.get_dataloader(self.conf.get("data")),
                               make_apply_fn(model, self.device), pred_file,
                               keys=self.export_keys + self.optional_export_keys,
                               items_per_dispatch=self.conf.get("items_per_dispatch"))
        return pred_file

    def run_eval(self, loader, pred_file):
        raise NotImplementedError

    def save_conf(self, experiment_dir: Path, overwrite=False, overwrite_eval=False) -> None:
        """Write conf.yaml; refuse a changed `model` without `overwrite` and
        a changed `eval` without `overwrite` or `overwrite_eval`."""
        conf_output_path = Path(experiment_dir) / "conf.yaml"
        if conf_output_path.exists():
            saved_conf = from_yaml(str(conf_output_path))
            if self.conf.get("model") != saved_conf.get("model") and not overwrite:
                raise ValueError("Config changed (model): rerun with --overwrite")
            if self.conf.get("eval") != saved_conf.get("eval") and not (overwrite or overwrite_eval):
                raise ValueError("Config changed (eval): rerun with --overwrite_eval")
        conf_output_path.parent.mkdir(parents=True, exist_ok=True)
        conf_output_path.write_text(self.conf.to_yaml())

    def run(self, experiment_dir: Path, model=None, overwrite=False, overwrite_eval=False):
        """Both loops; the cache and the eval are reused unless overwritten.
        `model` (in memory) skips loading one from the conf."""
        experiment_dir = Path(experiment_dir)
        experiment_dir.mkdir(parents=True, exist_ok=True)
        self.save_conf(experiment_dir, overwrite=overwrite, overwrite_eval=overwrite_eval)
        pred_file = self.get_predictions(experiment_dir, model=model, overwrite=overwrite)
        f = {}
        if not exists_eval(experiment_dir) or overwrite_eval or overwrite:
            s, f, r = self.run_eval(self.get_dataloader(self.conf.get("data")), pred_file)
            save_eval(experiment_dir, s, f, r)
        s, r = load_eval(experiment_dir)
        logger.info("Eval summaries: %s", s)
        return s, f, r
