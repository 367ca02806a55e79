"""Checkpoints of training runs (counterpart of
`gluefactory_tpu/utils/experiments.py`).

The JAX package's names with a `.tar` suffix: `checkpoint_{epoch}_{iter}`
(`_interrupted` when a run stopped on SIGINT), the best one copied to
`checkpoint_best`, the last `keep_last_checkpoints` kept. Each is a
`torch.save` dict: the model's and the optimizer's state dicts, the train
step's counters, epoch, iter and the last evaluation. Beside them:
`config.yaml` and `eval_{epoch}_{iter}.json`.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import numpy as np
import torch

from .. import logger
from ..core.config import Config
from ..settings import TRAINING_PATH

_NAME = re.compile(r"checkpoint_(\d+)_(\d+)(_interrupted)?\.tar")


def list_checkpoints(dir_: Path) -> list:
    """[((epoch, iter), path)] of the checkpoints in a directory, in order."""
    checkpoints = []
    for p in Path(dir_).glob("checkpoint_*.tar"):
        m = _NAME.fullmatch(p.name)
        if m:
            checkpoints.append(((int(m.group(1)), int(m.group(2))), p))
    return sorted(checkpoints, key=lambda x: x[0])


def get_last_checkpoint(exper, allow_interrupted: bool = True) -> Path:
    ckpts = list_checkpoints(Path(TRAINING_PATH, exper))
    if not allow_interrupted:
        ckpts = [(k, p) for (k, p) in ckpts if "_interrupted" not in p.name]
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint in experiment {exper}")
    return ckpts[-1][1]


def get_best_checkpoint(exper) -> Path:
    p = Path(TRAINING_PATH, exper, "checkpoint_best.tar")
    if not p.exists():
        raise FileNotFoundError(f"no best checkpoint in experiment {exper}")
    return p


def delete_old_checkpoints(dir_: Path, num_keep: int) -> None:
    ckpts = list_checkpoints(dir_)
    for _, p in ckpts[: max(len(ckpts) - num_keep, 0)]:
        logger.info("Deleting checkpoint %s", p.name)
        p.unlink()


def save_checkpoint(state: dict, conf, results: dict, output_dir: Path, epoch: int, iter_i: int,
                    interrupted: bool = False) -> Path:
    """Write `state` (model / optimizer state dicts, counters) with epoch,
    iter and the scalar `results`; also config.yaml and the eval json."""
    output_dir = Path(output_dir)
    cp_name = f"checkpoint_{epoch}_{iter_i}" + ("_interrupted" if interrupted else "") + ".tar"
    logger.info("Saving checkpoint %s", cp_name)
    scalars = {k: float(v) for k, v in (results or {}).items() if np.ndim(v) == 0}
    path = output_dir / cp_name
    torch.save({**state, "epoch": epoch, "iter": iter_i, "eval": scalars}, path)
    conf = conf if isinstance(conf, Config) else Config(conf)
    (output_dir / "config.yaml").write_text(conf.to_yaml())
    with open(output_dir / f"eval_{epoch}_{iter_i}.json", "w") as f:
        json.dump(scalars, f, indent=2)
    return path


def update_best_checkpoint(path: Path, results: dict, best_key: str, best_eval):
    """Copy `path` to checkpoint_best if `best_key` improved (lower is
    better); returns the best value so far."""
    if results is None or best_key not in results:
        return best_eval
    value = float(results[best_key])
    if best_eval is None or value < best_eval:
        logger.info("New best checkpoint: %s=%s", best_key, value)
        shutil.copy(path, path.parent / "checkpoint_best.tar")
        return value
    return best_eval


def load_checkpoint(path: Path, map_location="cpu") -> dict:
    """A checkpoint's dict. The file is one this package wrote: it holds only
    tensors, numbers, strings and containers, so it loads with
    `weights_only=True`."""
    return torch.load(path, map_location=map_location, weights_only=True)
