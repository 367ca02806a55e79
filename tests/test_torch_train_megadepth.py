"""Stage-2 training on MegaDepth in the port against the JAX package, on the
CPU at a tiny size: procedural scenes in MegaDepth's D2-Net layout
(`scripts_dev/posed_scenes.write_megadepth_scene`, 128 x 96 images
square-padded), SuperPoint (small channels, 48 keypoints forced, frozen) +
LightGlue (2 layers, d = 64, 2 heads) with the `depth_matcher` ground truth
of `superpoint+lightglue_megadepth.yaml` (th_positive 3, th_negative 5,
th_epi 5).

- Two Adam steps from the same weights (`from_jax_params`) on the same
  batches as JAX's `make_train_step`, `checkpointed` on and off: losses
  within 1e-4 relative, step-0 gradients within 1e-4 of their global norm,
  parameters after two steps within 3 * lr * steps absolute.
- The config's lr schedule (`exp`, start 30, exp_div_10 10) equals JAX's.
- The trainer's three stage-2 routes through `train.main`: the warm start
  (`load_experiment`) loads a stage-1 experiment's best checkpoint
  bit-equal; `dataset_callback_fn: sample_new_items` draws the training
  pairs with `seed + epoch` at each epoch, the loader rebuilt on them.
- The CLI on the shipped config with tiny overrides trains one epoch.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gluefactory_tpu.data.megadepth as jmd
import gluefactory_tpu_torch.settings as tsettings
from gluefactory_tpu import train as jax_train
from gluefactory_tpu.core.config import Config as JConfig
from gluefactory_tpu.data import get_dataset as jax_get_dataset
from gluefactory_tpu.data.base_dataset import collate as jax_collate
from gluefactory_tpu.data.base_dataset import prepare_batch as jax_prepare_batch
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch import train as torch_train
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.core.config import Config, from_yaml, merge
from gluefactory_tpu_torch.data import get_dataset, megadepth
from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene
from gluefactory_tpu_torch.utils import experiments


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file's tests and fixtures: the suite runs 6
    workers on the host's cores, and torch's default pool oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
CONF = ROOT / "gluefactory_tpu_torch/configs/superpoint+lightglue_megadepth.yaml"
STAGE1 = ROOT / "gluefactory_tpu_torch/configs/superpoint+lightglue_homography.yaml"
K, HEADS, LR, STEPS, B = 48, 2, 1e-3, 2, 2
SIZE = (128, 96)
YAML = from_yaml(str(CONF))
MODEL = merge(YAML.model, {
    "extractor": {"channels": [8, 8, 16, 16], "head_channels": 32, "descriptor_dim": 64,
                  "max_num_keypoints": K},
    "matcher": {"input_dim": 64, "descriptor_dim": 64, "n_layers": 2, "num_heads": HEADS,
                "flash": False},
}).to_dict()
DATA = {"train_split": ["s0", "s1"], "train_num_per_scene": 6, "min_overlap": 0.1,
        "max_overlap": 0.7, "num_overlap_bins": 3,
        "preprocessing": {"resize": 128, "side": "long", "square_pad": True}}
# the CLI's tiny overrides of the shipped configs (both stages: equal widths)
TINY = ["--device", "cpu", "--no_tensorboard", "--no_capture", "--max_val_iters", "1",
        f"model.extractor.max_num_keypoints={K}", "model.matcher.n_layers=2",
        "model.matcher.descriptor_dim=64", f"model.matcher.num_heads={HEADS}",
        "train.log_every_iter=1"]
STAGE2 = ["data.data_dir=megadepth", "data.train_split=[s0,s1]", "data.val_split=[s2]",
          "data.train_num_per_scene=3", "data.batch_size=2", "data.num_workers=0",
          "data.preprocessing.resize=128"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    for s in range(3):
        write_megadepth_scene(root / "megadepth", f"s{s}", n_views=8, size=SIZE, seed=s)
    lists = root / "megadepth" / "scene_lists"
    lists.mkdir()
    (lists / "valid_pairs.txt").write_text(
        "s2/images/s2_im00.jpg s2/images/s2_im02.jpg\ns2/images/s2_im03.jpg s2/images/s2_im04.jpg\n")
    return root


@pytest.fixture()
def paths(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(jmd, "DATA_PATH", data_root)
    monkeypatch.setattr(tsettings, "DATA_PATH", data_root)
    monkeypatch.setattr(torch_train, "TRAINING_PATH", tmp_path)
    monkeypatch.setattr(experiments, "TRAINING_PATH", tmp_path, raising=False)
    return data_root, tmp_path


def train_conf(**kw):
    return merge(Config(torch_train.default_train_conf), {"lr": LR, "lr_schedule": YAML.train.lr_schedule},
                 kw)


@pytest.fixture(scope="module")
def jax_run(data_root):
    """Batches from both packages' datasets (equal items), JAX's initial
    params and step-0 gradients, and per `checkpointed` the losses of two
    steps and the final params."""
    old = jmd.DATA_PATH, tsettings.DATA_PATH
    jmd.DATA_PATH = tsettings.DATA_PATH = data_root
    try:
        items = get_dataset("megadepth")(DATA).get_dataset("train")
        jax_items = jax_get_dataset("megadepth")(DATA).get_dataset("train")
        assert items.items == jax_items.items
        idx = [list(range(i * B, (i + 1) * B)) for i in range(STEPS)]
        batches = [prepare_batch(collate([items[i] for i in ix]), "cpu") for ix in idx]
        jb = [jax_train.strip_non_arrays(jax_prepare_batch(jax_collate([jax_items[i] for i in ix])))
              for ix in idx]
    finally:
        jmd.DATA_PATH, tsettings.DATA_PATH = old
    out = {"batches": batches}
    key = jax.random.key(0)
    for checkpointed in (False, True):
        conf = merge(Config(MODEL), {"matcher": {"checkpointed": checkpointed}}).to_dict()
        model = jax_get_model("two_view_pipeline").from_conf(
            {k: v for k, v in conf.items() if k != "name"})
        if not checkpointed:
            params = jax.jit(model.init, static_argnames="method")(
                {"params": key, "sample": key}, jb[0], method="initialize")["params"]

            def loss_fn(p):
                outs, _ = model.apply({"params": p}, jb[0], method="forward_with_loss",
                                      mutable=["batch_stats"], rngs={"sample": key})
                return outs[1]["total"].mean()

            out["params"] = jax.tree.map(np.asarray, params)
            out["grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))
        tx, _ = jax_train.build_optimizer(JConfig(train_conf().to_dict()), params, model, 4)
        opt_state = tx.init(params)
        step = jax.jit(jax_train.make_train_step(model, tx))
        variables, losses = {"params": params}, []
        for b in jb:
            variables, opt_state, ls, _, info = step(variables, opt_state, b, key)
            assert bool(info["ok"])
            losses.append({k: float(v) for k, v in ls.items()})
        out[checkpointed] = {"losses": losses,
                             "final": jax.tree.map(np.asarray, variables["params"])}
    return out


def port_model(params, checkpointed):
    conf = merge(Config(MODEL), {"matcher": {"checkpointed": checkpointed}}).to_dict()
    model = get_model("two_view_pipeline").from_conf(
        {k: v for k, v in conf.items() if k != "name"}, device="cpu")
    model.load_state_dict(from_jax_params(params, "two_view_pipeline", num_heads=HEADS))
    return model


def test_batches_hold_positives_and_detections(jax_run):
    """Every keypoint slot is a detection (so neither package's random fill
    enters) and the depth GT finds positives in each batch."""
    model = port_model(jax_run["params"], False)
    for batch in jax_run["batches"]:
        with torch.no_grad():
            pred = model(batch)
            gt = model.ground_truth({**batch, **pred})
        for i in "01":
            assert (pred[f"keypoint_scores{i}"] > 0).all()
        assert (gt["gt_matches0"] >= 0).sum() >= 4


@pytest.mark.parametrize("checkpointed", [False, True])
def test_two_steps_match_jax(jax_run, checkpointed):
    ref = jax_run[checkpointed]
    model = port_model(jax_run["params"], checkpointed)
    opt, schedule = torch_train.build_optimizer(train_conf(), model, 4)
    step = torch_train.TrainStep(model, opt, schedule, max_updates=STEPS)
    for i, (batch, want) in enumerate(zip(jax_run["batches"], ref["losses"])):
        losses, _, info = step(batch, torch.Generator().manual_seed(i))
        assert bool(info["ok"])
        assert {"total", "matcher_assignment_nll", "matcher_confidence"} <= set(want)
        for k, v in want.items():
            got = float(losses[k])
            assert abs(got - v) <= 1e-4 * max(abs(v), 1.0), (i, k, got, v)
        if i == 0 and not checkpointed:
            grads = from_jax_params(jax_run["grads"], "two_view_pipeline", num_heads=HEADS)
            gnorm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())))
            assert gnorm > 0
            for name, p in model.named_parameters():
                if p.requires_grad:
                    err = float((p.grad - grads[name]).abs().max())
                    assert err <= 1e-4 * gnorm, (name, err, gnorm)
    want = from_jax_params(ref["final"], "two_view_pipeline", num_heads=HEADS)
    for name, p in model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 3 * LR * STEPS, name


@pytest.mark.parametrize("steps_per_epoch", [1, 7, 2.5])
def test_config_lr_schedule_matches_jax(steps_per_epoch):
    conf = {"lr": YAML.train.lr, "epochs": 50, "lr_schedule": YAML.train.lr_schedule.to_dict()}
    mine = torch_train.build_lr_schedule(Config(conf), steps_per_epoch)
    ref = jax_train.build_lr_schedule(JConfig(conf), steps_per_epoch)
    for step in range(0, int(50 * steps_per_epoch), max(1, int(steps_per_epoch))):
        assert abs(mine(step) - float(ref(step))) <= 1e-6 * float(YAML.train.lr), step
    assert mine(int(45 * steps_per_epoch)) < 0.4 * float(YAML.train.lr)


def _argv(exp, conf, *extra):
    return [exp, "--conf", str(conf), *TINY, *extra]


def test_warm_start_and_per_epoch_resampling(paths, monkeypatch):
    """Stage 1 (tiny homography run), then stage 2 warm-started from it
    through `train.main`: the model's state before its first step equals
    stage 1's best checkpoint bit for bit; `sample_new_items` runs at each
    epoch with `seed + epoch`, and each epoch trains on the pairs it drew."""
    data_root, out = paths
    torch_train.main(_argv("stage1", STAGE1, "data.synthetic_images=12", "data.train_size=4",
                           "data.val_size=2", "data.batch_size=2", "data.num_workers=0",
                           "data.source_size=[160,120]", "data.homography.patch_shape=[160,120]",
                           "data.photometric.name=identity", "train.epochs=1"))
    best = experiments.load_checkpoint(experiments.get_best_checkpoint("stage1"))["model"]

    seeds, epoch_items, first_state, trained = [], [], [], []
    sample = megadepth._MegaDepthItems.sample_new_items

    def recorded_sample(self, seed):
        sample(self, seed)
        if self.split == "train":
            seeds.append(seed)
            epoch_items.append(list(self.items))

    call = torch_train.TrainStep.__call__

    def recorded_step(self, batch, generator=None):
        if not first_state:
            first_state.append({k: v.clone() for k, v in self.model.state_dict().items()})
        trained.append(list(batch["name"]))
        return call(self, batch, generator)

    monkeypatch.setattr(megadepth._MegaDepthItems, "sample_new_items", recorded_sample)
    monkeypatch.setattr(torch_train.TrainStep, "__call__", recorded_step)
    torch_train.main(_argv("stage2", CONF, *STAGE2, "train.load_experiment=stage1", "train.epochs=2"))

    assert set(first_state[0]) == set(best)
    for k, v in best.items():
        assert torch.equal(first_state[0][k], v), k
    conf_seed = 0
    assert seeds == [conf_seed, conf_seed + 0, conf_seed + 1]  # __init__, then epochs 0 and 1
    assert epoch_items[1] == epoch_items[0] and epoch_items[2] != epoch_items[1]
    # the CPU's own draw of epoch 1 is what the loader served in epoch 1
    fresh = get_dataset("megadepth")(
        merge(from_yaml(str(CONF)).data, {"train_split": ["s0", "s1"], "val_split": ["s2"],
                                          "train_num_per_scene": 3})).get_dataset("train")
    fresh.sample_new_items(conf_seed + 1)
    assert fresh.items == epoch_items[2]
    steps = len(epoch_items[0]) // 2
    served = [set(n for b in trained[e * steps:(e + 1) * steps] for n in b) for e in (0, 1)]
    for e in (0, 1):
        names = {f"{s}/{Path(str(fresh.images[s][i])).name}_{Path(str(fresh.images[s][j])).name}"
                 for s, i, j, _ in epoch_items[e + 1]}
        assert served[e] <= names and len(served[e]) == 2 * steps
    ckpt = experiments.load_checkpoint(experiments.get_last_checkpoint("stage2"))
    assert ckpt["epoch"] == 1 and ckpt["step"]["updates"] == 2 * steps


def test_cli_trains_one_epoch(paths):
    """`python -m gluefactory_tpu_torch.train` on the shipped stage-2
    config, tiny overrides, no warm start: finite losses, validation on
    the data dir's `valid_pairs.txt`, the checkpoints."""
    data_root, out = paths
    env = {**os.environ, "GLUEFACTORY_TRAINING": str(out), "GLUEFACTORY_DATA": str(data_root)}
    res = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.train",
                          *_argv("cli", CONF, *STAGE2, "train.load_experiment=null", "train.epochs=1")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    log = res.stdout + res.stderr
    assert res.returncode == 0, log
    assert "[E 0 | it 2]" in log and "[Validation]" in log and "Finished training." in log
    assert "nan" not in log.split("[E 0 | it 0]")[1].split("[Validation]")[0]
    assert (out / "cli" / "checkpoint_best.tar").exists()
