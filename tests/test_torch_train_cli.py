"""`python -m gluefactory_tpu_torch.train` on the CPU (`--device cpu`) with
the verify recipe's overrides of `superpoint+lightglue_homography.yaml`:
finite losses, a `[Validation]` line, the checkpoints and
`checkpoint_best`, and `--restore` resuming from the last checkpoint. Also
the CLI's defaults and refusals, and the host-side helpers (metric
accumulators, checkpoint bookkeeping) against the JAX package's."""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gluefactory_tpu.utils import tools as jtools
from gluefactory_tpu_torch import train
from gluefactory_tpu_torch.core.config import Config, merge
from gluefactory_tpu_torch.utils import experiments, tools
from gluefactory_tpu_torch.utils.tensor import batch_to_device, index_batch, map_tensor, rbd

ROOT = Path(__file__).resolve().parents[1]
CONF = "gluefactory_tpu/configs/superpoint+lightglue_homography.yaml"
RECIPE = [
    "--no_tensorboard", "--max_val_iters", "1",
    "data.synthetic_images=12", "data.train_size=4", "data.val_size=2", "data.batch_size=2",
    "data.num_workers=0", "data.source_size=[160,120]", "data.homography.patch_shape=[160,120]",
    "data.photometric.name=identity", "model.extractor.max_num_keypoints=48",
    "model.matcher.n_layers=2", "model.matcher.descriptor_dim=64", "model.matcher.num_heads=2",
    "train.log_every_iter=1", "train.eval_every_iter=100",
]
LOSS = re.compile(r"\[E (\d+) \| it (\d+)\] loss \{(.*)\} lr")


def run_cli(out_dir, *args):
    env = {**os.environ, "GLUEFACTORY_TRAINING": str(out_dir)}
    res = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.train", "vtest",
                          "--device", "cpu", "--conf", CONF, *RECIPE, *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout + res.stderr


def losses_of(log):
    out = []
    for epoch, it, body in LOSS.findall(log):
        terms = dict(t.rsplit(" ", 1) for t in body.split(", "))
        out.append((int(epoch), int(it), {k: float(v) for k, v in terms.items()}))
    return out


def test_train_checkpoint_and_restore(tmp_path):
    log = run_cli(tmp_path, "--no_capture", "train.epochs=1", "model.matcher.checkpointed=False")
    steps = losses_of(log)
    assert [(e, i) for e, i, _ in steps] == [(0, 0), (0, 1)]
    for _, _, terms in steps:
        assert {"total", "matcher_assignment_nll", "matcher_confidence"} <= set(terms)
        assert all(math.isfinite(v) for v in terms.values())
    assert "[Validation]" in log and "New best checkpoint" in log and "Finished training." in log
    exp = tmp_path / "vtest"
    assert [p.name for _, p in experiments.list_checkpoints(exp)] == ["checkpoint_0_2.tar"]
    assert (exp / "checkpoint_best.tar").exists() and (exp / "config.yaml").exists()
    assert (exp / "eval_0_2.json").exists()
    first = experiments.load_checkpoint(exp / "checkpoint_0_2.tar")
    assert first["epoch"] == 0 and first["iter"] == 2 and first["step"]["updates"] == 2
    assert math.isfinite(first["eval"]["loss/total"])

    # resume: epoch 1 from the last checkpoint, with the log captured
    log = run_cli(tmp_path, "--restore", "train.epochs=2", "model.matcher.checkpointed=True")
    assert "Restored from" in log and "checkpoint_0_2.tar" in log
    assert [(e, i) for e, i, _ in losses_of(log)] == [(1, 0), (1, 1)]
    names = [p.name for _, p in experiments.list_checkpoints(exp)]
    assert names == ["checkpoint_0_2.tar", "checkpoint_1_4.tar"]
    second = experiments.load_checkpoint(exp / "checkpoint_1_4.tar")
    assert second["step"]["updates"] == 4
    moved = [not torch.equal(second["model"][k], first["model"][k]) for k in first["model"]]
    assert any(moved)
    assert "Finished training." in (exp / "log.txt").read_text()


def test_port_config_copy_parses_as_the_jax_one():
    """The port's copy of the stage-1 config (the one chip_smoke.py trains
    on) parses to the same config as the JAX package's file, but for the
    figure hook, which names the port's function in place of the JAX
    package's."""
    from gluefactory_tpu.core.config import from_yaml as jax_from_yaml
    from gluefactory_tpu_torch.core.config import from_yaml

    ours = from_yaml(str(ROOT / "gluefactory_tpu_torch/configs/superpoint+lightglue_homography.yaml"))
    theirs = jax_from_yaml(str(ROOT / CONF))
    assert list(ours.train.plot) == [5, "gluefactory_tpu_torch.visualization.visualize_batch.make_match_figures"]
    assert list(theirs.train.plot) == [5, "gluefactory_tpu.visualization.visualize_batch.make_match_figures"]
    ours, theirs = ours.to_dict(), theirs.to_dict()
    ours["train"]["plot"] = theirs["train"]["plot"]
    assert ours == theirs
    assert ours["train"]["lr_schedule"]["type"] == "exp" and ours["model"]["matcher"]["checkpointed"]


def test_default_device_is_cuda(monkeypatch, tmp_path):
    args = train.main_args(["x", "--conf", CONF])
    assert args.device == "cuda" and args.dotlist == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = merge(Config(train.default_conf), {"data": {"name": "homographies"}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.training(conf, tmp_path, args)


@pytest.mark.parametrize("override,flag,error", [
    ({"train": {"run_benchmarks": ["hpatches", "megadepth1500", "eth3d", "zeb", "nope"]}}, None,
     NotImplementedError),
    ({}, "--n_devices=2", ValueError),
], ids=["run_benchmarks", "n_devices"])
def test_not_ported_options_raise(override, flag, error):
    """Each option the port lacks raises before training; of the
    benchmarks only a name that is none (all five are ported). More than
    one device without a process group raises a ValueError that names
    torchrun (`tests/test_torch_ddp.py` trains under one)."""
    conf = merge(Config(train.default_conf), override)
    args = train.main_args(["x"] + ([flag] if flag else []))
    with pytest.raises(error, match="torchrun" if error is ValueError else None):
        train.check_supported(conf, args)


def test_bf16_trains_through_the_cli(tmp_path):
    """`train.mixed_precision=bf16` with the recipe's `lg` photometry: finite
    losses, the updates applied, float32 parameters in the checkpoint."""
    recipe = [a for a in RECIPE if not a.startswith("data.photometric")]
    env = {**os.environ, "GLUEFACTORY_TRAINING": str(tmp_path)}
    res = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.train", "vtest", "--device",
                          "cpu", "--conf", CONF, *recipe, "--no_capture", "train.epochs=1",
                          "train.mixed_precision=bf16", "model.matcher.checkpointed=True"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log
    steps = losses_of(log)
    assert [(e, i) for e, i, _ in steps] == [(0, 0), (0, 1)]
    assert all(math.isfinite(v) for _, _, terms in steps for v in terms.values())
    ckpt = experiments.load_checkpoint(tmp_path / "vtest" / "checkpoint_0_2.tar")
    assert ckpt["step"]["updates"] == 2
    assert all(v.dtype == torch.float32 for v in ckpt["model"].values() if v.is_floating_point())
    with pytest.raises(NotImplementedError):
        train.check_supported(merge(Config(train.default_conf), {"train": {"mixed_precision": "fp16"}}),
                              train.main_args(["x"]))


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop"])
def test_optimizers_and_opt_regexp(name):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    conf = merge(Config(train.default_train_conf), {"optimizer": name, "opt_regexp": r"^1\."})
    opt, schedule = train.build_optimizer(conf, model, 10)
    assert [p for g in opt.param_groups for p in g["params"]] == list(model[1].parameters())
    assert schedule(0) == 1e-3
    step = train.TrainStep(_LossModel(model), opt, schedule, clip_grad=1e-3, max_updates=1)
    before = [p.detach().clone() for p in model.parameters()]
    losses, _, info = step({"x": torch.ones(5, 3)})
    assert bool(info["ok"]) and math.isfinite(float(losses["total"]))
    after = list(model.parameters())
    assert torch.equal(before[0], after[0]) and not torch.equal(before[2], after[2])


class _LossModel(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward_with_loss(self, data, train=True, generator=None):
        y = self.net(data["x"])
        return {}, {"total": (y**2).sum(-1)}, {}


def test_metric_accumulators_match_jax():
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=7) for _ in range(3)]
    chunks[1][2] = np.nan
    pairs = [(tools.AverageMetric(), jtools.AverageMetric()),
             (tools.MedianMetric(), jtools.MedianMetric()),
             (tools.RecallMetric([0.0, 0.5]), jtools.RecallMetric([0.0, 0.5]))]
    for ours, theirs in pairs:
        for c in chunks:
            ours.update(torch.from_numpy(c))
            theirs.update(c)
        np.testing.assert_allclose(ours.compute(), theirs.compute(), rtol=1e-12)
    ours, theirs = tools.PRMetric(), jtools.PRMetric()
    mask = rng.uniform(size=7) > 0.3
    ours.update(torch.from_numpy(chunks[0] > 0), torch.from_numpy(chunks[2]), torch.from_numpy(mask))
    theirs.update(chunks[0] > 0, chunks[2], mask)
    for a, b in zip(ours.compute(), theirs.compute()):
        np.testing.assert_array_equal(a, b)
    assert math.isnan(tools.AverageMetric().compute())


def test_seed_and_fork_rng():
    gen = tools.set_seed(5)
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator().manual_seed(5)))
    tools.set_seed(5)
    a, t = np.random.rand(), torch.rand(2)
    tools.set_seed(5)
    with tools.fork_rng(1):
        np.random.rand()
        torch.rand(4)
    assert np.random.rand() == a and torch.equal(torch.rand(2), t)


def test_tensor_helpers():
    batch = {"a": torch.arange(6).reshape(2, 3), "b": {"c": np.ones((2, 1))}, "name": ["x", "y"]}
    moved = batch_to_device(batch, "cpu")
    assert torch.is_tensor(moved["b"]["c"]) and moved["name"] == ["x", "y"]
    assert rbd(moved)["a"].tolist() == [0, 1, 2]
    items = list(index_batch({k: v for k, v in moved.items() if k != "name"}))
    assert len(items) == 2 and items[1]["a"].tolist() == [3, 4, 5]
    assert map_tensor(batch, lambda t: t * 0)["a"].sum() == 0


def test_checkpoint_bookkeeping(tmp_path):
    for e, i in ((0, 5), (1, 10), (2, 15), (3, 20)):
        experiments.save_checkpoint({"model": {"w": torch.ones(2) * e}}, {"a": 1}, {"loss/total": 3 - e},
                                    tmp_path, e, i, interrupted=e == 3)
    names = [p.name for _, p in experiments.list_checkpoints(tmp_path)]
    assert names == ["checkpoint_0_5.tar", "checkpoint_1_10.tar", "checkpoint_2_15.tar",
                     "checkpoint_3_20_interrupted.tar"]
    best = experiments.update_best_checkpoint(tmp_path / names[1], {"loss/total": 2.0}, "loss/total", None)
    assert best == 2.0
    assert experiments.update_best_checkpoint(tmp_path / names[2], {"loss/total": 2.5},
                                              "loss/total", best) == 2.0
    assert torch.equal(experiments.load_checkpoint(tmp_path / "checkpoint_best.tar")["model"]["w"],
                       torch.ones(2))
    experiments.delete_old_checkpoints(tmp_path, 2)
    assert [p.name for _, p in experiments.list_checkpoints(tmp_path)] == names[2:]
    assert (tmp_path / "eval_1_10.json").read_text().strip().startswith("{")
