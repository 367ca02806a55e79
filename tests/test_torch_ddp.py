"""Data-parallel training (`utils/distributed.py` in `train.py`) on the CPU:
`python -m gluefactory_tpu_torch.train` in 2 gloo processes (spawned, their
rendezvous a `FileStore` under `tmp_path`) against one process on the
global batch, for 2 updates of a tiny SuperGlue stage 1, whose train-mode
BatchNorm makes statistics that are not synchronised fail the test. Every
keypoint slot is a detection, so no step draws random keypoints. The
training split is not shuffled: torch's one-process loader draws its order
from another generator state than `DistributedSampler` (as in the JAX
package), so only then is the one process's batch the union of the ranks'.

Tolerances: the losses (the ranks' mean against the one process's) 1e-6
relative; each update's gradients 1e-5 of the largest gradient entry; the
parameters and the BatchNorm running statistics after each update 1e-5
relative to each tensor's largest entry, or to the largest move of an
update (lr x the largest gradient) for a tensor still below it, as the
BatchNorm biases that start at 0 (float32 sums over the global batch in
another order). The ranks hold bit-equal gradients and states: they
apply the same all-reduced update. The runs train with SGD: Adam's first
steps move every parameter by about lr whatever its gradient's size, so the
bias before each BatchNorm, whose exact gradient is 0 and whose computed
gradient is rounding noise, would move by a sign that the order of the
sums decides (2e-4 apart at the config's lr 1e-4); the reduction is the
same for every optimizer.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gluefactory_tpu_torch import train
from gluefactory_tpu_torch.core.config import Config, from_yaml, merge
from gluefactory_tpu_torch.data.device_homography import generate_homography_pairs
from gluefactory_tpu_torch.utils import distributed, threefry

ROOT = Path(__file__).resolve().parents[1]
B, WORLD, STEPS, LR = 2, 2, 2, 0.01  # items a rank, ranks, updates, SGD's lr
MATCHER = {"name": "superglue", "descriptor_dim": 256, "keypoint_encoder": [32, 64, 128, 256],
           "n_layers": 1, "num_heads": 4, "sinkhorn_iterations": 10, "filter_threshold": 0.2,
           "checkpointed": False}
RECIPE = [
    "--device", "cpu", "--no_tensorboard", "--max_val_iters", "1",
    f"data.synthetic_images={2 * STEPS * B * WORLD}", f"data.train_size={STEPS * B * WORLD}",
    f"data.val_size={B * WORLD}", "data.num_workers=0", "data.source_size=[160,120]",
    "data.homography.patch_shape=[160,120]", "data.photometric.name=identity",
    "model.extractor.max_num_keypoints=32", "model.extractor.detection_threshold=0.0",
    "model.extractor.force_num_keypoints=True", "train.epochs=1", "train.log_every_iter=1",
    "train.eval_every_iter=100", "data.shuffle_training=False", "train.optimizer=sgd",
    f"train.lr={LR}",
]

# one process of a run: the trainer's CLI entry point with every step's
# batch items, losses and state recorded, the checkpoint writes counted,
# then (after a barrier) `--restore`
WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from gluefactory_tpu_torch import train
from gluefactory_tpu_torch.utils import distributed

out, argv = sys.argv[1], json.loads(sys.argv[2])
rec = {"steps": [], "saves": 0, "detections": []}
call, save = train.TrainStep.__call__, train.save_checkpoint

def recorded(self, batch, *args):
    if not rec["steps"]:
        self.model.extractor.register_forward_hook(
            lambda m, i, o: rec["detections"].append(bool((o["keypoint_scores"] > 0).all())))
    res = call(self, batch, *args)
    rec["steps"].append({"idx": batch["idx"].tolist(), "ok": bool(res[2]["ok"]),
                         "losses": {k: float(v) for k, v in res[0].items()},
                         "state": {k: v.clone() for k, v in self.model.state_dict().items()},
                         "grads": {n: p.grad.clone() for n, p in self.model.named_parameters()
                                   if p.grad is not None}})
    return res

def counted(*args, **kwargs):
    rec["saves"] += 1
    return save(*args, **kwargs)

train.TrainStep.__call__, train.save_checkpoint = recorded, counted
train.main(argv)
group = distributed.setup("cpu")
if group is not None:
    torch.distributed.barrier()  # rank 0 has written the checkpoint
train.TrainStep.__call__ = call
rec["restored"] = train.main(argv + ["--restore"]).state_dict()
rec["group"] = None if group is None else [group.rank, group.world]
torch.save(rec, out)
"""


def _launch(tmp_path, name, argv, env):
    out = tmp_path / f"{name}.pt"
    proc = subprocess.Popen([sys.executable, "-c", WORKER, str(out), json.dumps(argv)], cwd=ROOT,
                            env={**os.environ, **env}, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank run and the one-process run on the global batch, all
    three processes at once."""
    tmp = tmp_path_factory.mktemp("ddp")
    conf = from_yaml(str(ROOT / "gluefactory_tpu_torch/configs/superpoint+lightglue_homography.yaml"))
    conf = conf.to_dict()
    conf["model"]["matcher"] = MATCHER
    yaml = tmp / "superglue.yaml"
    yaml.write_text(Config(conf).to_yaml())
    argv = ["ddp", "--conf", str(yaml), *RECIPE]
    base = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [_launch(tmp, "single", argv + [f"data.batch_size={B * WORLD}"],
                     {**base, "GLUEFACTORY_TRAINING": str(tmp / "single")})]
    for rank in range(WORLD):
        procs.append(_launch(tmp, f"rank{rank}", argv + [f"data.batch_size={B}", f"--n_devices={WORLD}"],
                             {**base, "GLUEFACTORY_TRAINING": str(tmp / "ddp"), "RANK": str(rank),
                              "LOCAL_RANK": str(rank), "WORLD_SIZE": str(WORLD),
                              "GLUEFACTORY_DIST_INIT": f"file://{tmp / 'store'}"}))
    logs = [p.communicate(timeout=240)[0] for p, _ in procs]
    for (p, _), log in zip(procs, logs):
        assert p.returncode == 0, log
    single, *ranks = (torch.load(out, weights_only=False) for _, out in procs)
    return {"single": single, "ranks": ranks, "logs": logs, "dir": tmp}


def _close(got, want, rtol, what, floor=1e-12):
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        scale = max(float(w.abs().max()), floor)
        err = float((got[k] - w).abs().max())
        assert err <= rtol * scale, f"{what} {k}: {err} > {rtol} x {scale}"


def test_shards_are_disjoint_and_cover_the_global_batch(runs):
    single, ranks = runs["single"], runs["ranks"]
    assert [r["group"] for r in ranks] == [[0, WORLD], [1, WORLD]] and single["group"] is None
    assert len(single["steps"]) == STEPS and all(len(r["steps"]) == STEPS for r in ranks)
    for i in range(STEPS):
        shards = [set(r["steps"][i]["idx"]) for r in ranks]
        assert all(len(s) == B for s in shards) and not shards[0] & shards[1]
        assert shards[0] | shards[1] == set(single["steps"][i]["idx"])
    assert all(single["detections"]) and all(all(r["detections"]) for r in ranks)


def test_steps_equal_the_single_process_on_the_global_batch(runs):
    single, ranks = runs["single"], runs["ranks"]
    for i in range(STEPS):
        assert single["steps"][i]["ok"] and all(r["steps"][i]["ok"] for r in ranks)
        for k, want in single["steps"][i]["losses"].items():
            got = np.mean([r["steps"][i]["losses"][k] for r in ranks])
            assert got == pytest.approx(want, rel=1e-6), (i, k)
        ga, gb = (r["steps"][i]["grads"] for r in ranks)
        want = single["steps"][i]["grads"]
        assert set(ga) == set(want) and all(torch.equal(ga[k], gb[k]) for k in ga)
        scale = max(float(g.abs().max()) for g in want.values())
        for k, g in want.items():
            assert float((ga[k] - g).abs().max()) <= 1e-5 * scale, (i, k)
        a, b = (r["steps"][i]["state"] for r in ranks)
        assert all(torch.equal(a[k], b[k]) for k in a), f"step {i}: the ranks' states differ"
        _close(a, single["steps"][i]["state"], 1e-5, f"step {i}", floor=LR * scale)
    stats = [k for k in a if k.endswith("running_var")]
    assert stats and not all(torch.equal(a[k], runs["single"]["steps"][0]["state"][k]) for k in stats)


def test_one_checkpoint_writer_and_restore_on_every_rank(runs):
    ranks = runs["ranks"]
    assert [r["saves"] for r in ranks] == [1, 0] and runs["single"]["saves"] == 1
    assert len(list((runs["dir"] / "ddp" / "ddp").glob("checkpoint_*.tar"))) == 2  # last and best
    last = ranks[0]["steps"][-1]["state"]
    for r in ranks:
        assert all(torch.equal(r["restored"][k], v) for k, v in last.items())


def test_logged_losses_are_the_global_batch(runs):
    """Each rank logs the all-reduced losses: the same line on both."""
    lines = [[ln for ln in log.splitlines() if "] loss {" in ln] for log in runs["logs"][1:]]
    assert len(lines[0]) == STEPS and [ln.split("lr")[0] for ln in lines[0]] == \
        [ln.split("lr")[0] for ln in lines[1]]


def test_n_devices_must_be_the_group_size():
    conf = Config(train.default_conf)
    for n, group in ((2, None), (3, distributed.Group(0, 2, torch.device("cpu")))):
        with pytest.raises(ValueError, match="torchrun" if group is None else "size"):
            train.check_supported(conf, train.main_args(["x", f"--n_devices={n}"]), group)
    train.check_supported(conf, train.main_args(["x", "--n_devices=2"]),
                          distributed.Group(1, 2, torch.device("cpu")))
    train.check_supported(conf, train.main_args(["x", "--n_devices=1"]))


def test_sharded_draws_are_the_global_batch_rows():
    """`batch_rand` and `device_augment` inside `sharded`: each rank's rows
    of what the global batch draws."""
    g = torch.Generator()
    want = torch.rand((6, 5, 2), generator=g.manual_seed(3))
    for rank in range(3):
        with distributed.sharded(distributed.Group(rank, 3, torch.device("cpu"))):
            got = distributed.batch_rand((2, 5, 2), g.manual_seed(3), "cpu")
        assert torch.equal(got, want[2 * rank:2 * rank + 2])
    rng = np.random.default_rng(0)
    sources = torch.from_numpy(rng.uniform(0, 1, (4, 60, 80, 3)).astype(np.float32))
    key = threefry.fold_in(threefry.split(0, 3)[2], 5)
    kw = dict(patch_size=(64, 48), difficulty=0.7, max_angle=45.0)
    whole = generate_homography_pairs(sources, key, **kw)
    for rank in range(2):
        part = generate_homography_pairs(sources[2 * rank:2 * rank + 2], key, shard=(rank, 2), **kw)
        for view in ("view0", "view1"):
            assert torch.equal(part[view]["image"], whole[view]["image"][2 * rank:2 * rank + 2])
        assert torch.equal(part["H_0to1"], whole["H_0to1"][2 * rank:2 * rank + 2])


def test_without_a_group_nothing_is_sharded(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.setup("cpu") is None
    assert distributed.batch_shard() == (0, 1)
    x = torch.arange(4.0)
    assert distributed.batch_mean(x) is x
    conf = merge(Config(train.default_conf), {})
    train.check_supported(conf, train.main_args(["x"]))
