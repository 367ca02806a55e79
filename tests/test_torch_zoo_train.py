"""A scaled-down `aliked+lightglue_homography` train step in the port
against the JAX package's `make_train_step`, with the frozen ALIKED's
BatchNorm as the JAX trainer treats it.

The JAX model runs its extractor with `train=True` on the two views stacked
into one batch, and ALIKED's BatchNorm follows `train` alone
(`use_running_average=not train`): in a step it normalises by the stacked
batch, and `make_train_step` keeps the mutated `batch_stats` in the
variables it returns (`{"params": ..., **updates}`), so they carry into
the next step and into the checkpoint. The port's frozen extractor does
the same under no_grad; its statistics live in its state dict.

Two SGD steps (lr 0.1, no schedule) on the same batches, every keypoint
slot a detection (asserted), so neither package's random fill enters.
Tolerances: the losses within 1e-4 relative; step 0's LightGlue
gradients (from JAX's parameter change over the lr) within 1e-4 of their
global norm; the extractor's running statistics after each step within
1e-5 (the views' means over float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from zoo_params import random_variables

from gluefactory_tpu import train as jax_train
from gluefactory_tpu.core.config import Config as JConfig
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch import train as torch_train
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.core.config import Config, from_yaml, merge
from gluefactory_tpu_torch.data.base_dataset import collate
from gluefactory_tpu_torch.data.homographies import HomographyDataset
from gluefactory_tpu_torch.eval.io import parse_config_path
from gluefactory_tpu_torch.models import get_model

K, HEADS, LR, STEPS, B = 32, 2, 0.1, 2, 2
OVERRIDES = {"extractor": {"model_name": "aliked-t16", "max_num_keypoints": K},
             "matcher": {"input_dim": 64, "descriptor_dim": 64, "n_layers": 2, "num_heads": HEADS,
                         "flash": False}}
TRAIN = {"lr": LR, "optimizer": "sgd", "lr_schedule": {"type": None}}
DATA = {"synthetic_images": 8, "train_size": 4, "val_size": 2, "source_size": [96, 80],
        "homography": {"patch_shape": [80, 64], "difficulty": 0.5, "max_angle": 30},
        "photometric": {"name": "identity"}}


def model_conf():
    conf = merge(from_yaml(str(parse_config_path("aliked+lightglue_homography"))).model, OVERRIDES)
    conf = conf.to_dict()
    assert conf["extractor"]["trainable"] is False and conf["matcher"]["checkpointed"] is True
    return {k: v for k, v in conf.items() if k != "name"}


def train_conf():
    return merge(Config(torch_train.default_train_conf), TRAIN)


def make_batches():
    ds = HomographyDataset(DATA).get_dataset("train")
    return [{k: v for k, v in collate([ds[i * B + j] for j in range(B)]).items() if k not in ("name", "idx")}
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def runs():
    batches = make_batches()
    jb = [jax.tree.map(lambda t: jnp.asarray(t.numpy()), b) for b in batches]
    model_j = jax_get_model("two_view_pipeline").from_conf(model_conf())
    variables = random_variables(model_j, jb[0], method="initialize")
    tx, _ = jax_train.build_optimizer(JConfig(train_conf().to_dict()), variables["params"], model_j, 1)
    opt_state = tx.init(variables["params"])
    step_j = jax.jit(jax_train.make_train_step(model_j, tx))
    ref, v = [], variables
    for b in jb:
        new, opt_state, losses, _, info = step_j(v, opt_state, b, jax.random.key(0))
        assert bool(info["ok"])
        ref.append({"losses": {k: float(x) for k, x in losses.items()},
                    "params": jax.tree.map(np.asarray, new["params"]),
                    "batch_stats": jax.tree.map(np.asarray, new["batch_stats"])})
        v = new

    port = get_model("two_view_pipeline").from_conf(model_conf(), device="cpu")
    port.load_state_dict(from_jax_params(variables["params"], "two_view_pipeline", num_heads=HEADS,
                                         batch_stats=variables["batch_stats"]))
    opt, schedule = torch_train.build_optimizer(train_conf(), port, 1)
    step = torch_train.TrainStep(port, opt, schedule, max_updates=STEPS)
    got = []
    for i, b in enumerate(batches):
        snapshot = {k: x.clone() for k, x in port.state_dict().items()}
        with torch.no_grad():  # the step's forward, to look at its keypoints; the state put back
            pred = port(b, train=True)
        port.load_state_dict(snapshot)
        for j in "01":
            assert (pred[f"keypoint_scores{j}"] > 0).all(), "a keypoint slot was filled at random"
        losses, _, info = step(b, torch.Generator().manual_seed(i))
        assert bool(info["ok"])
        got.append({"losses": {k: float(x) for k, x in losses.items()},
                    "grads": {n: p.grad.clone() for n, p in port.named_parameters() if p.requires_grad},
                    "state": {k: x.clone() for k, x in port.state_dict().items()}})
    return variables, ref, got


def test_losses_match_jax(runs):
    _, ref, got = runs
    for r, g in zip(ref, got):
        assert set(r["losses"]) <= set(g["losses"])
        for k, v in r["losses"].items():
            assert abs(g["losses"][k] - v) <= 1e-4 * max(abs(v), 1.0), (k, g["losses"][k], v)


def test_lightglue_gradients_match_jax(runs):
    variables, ref, got = runs
    before = from_jax_params(variables["params"], "two_view_pipeline", num_heads=HEADS,
                             batch_stats=variables["batch_stats"])
    after = from_jax_params(ref[0]["params"], "two_view_pipeline", num_heads=HEADS,
                            batch_stats=ref[0]["batch_stats"])
    grads = got[0]["grads"]
    assert grads and all(n.startswith("matcher.") for n in grads)
    want = {n: (before[n] - after[n]) / LR for n in grads}
    gnorm = float(torch.sqrt(sum((w.double() ** 2).sum() for w in want.values())))
    for n, g in grads.items():
        err = float((g - want[n]).abs().max())
        assert err <= 1e-4 * gnorm, (n, err, gnorm)
    # the frozen extractor's parameters did not move in JAX either
    for n, v in before.items():
        if n.startswith("extractor.") and "running" not in n and "num_batches" not in n:
            assert torch.equal(v, after[n]), n


def test_frozen_extractor_statistics_follow_jax(runs):
    """The running statistics after each step equal JAX's `batch_stats`,
    carried from step to step, and they moved."""
    variables, ref, got = runs
    initial = from_jax_params(variables["params"], "two_view_pipeline", num_heads=HEADS,
                              batch_stats=variables["batch_stats"])
    for r, g in zip(ref, got):
        want = from_jax_params(r["params"], "two_view_pipeline", num_heads=HEADS,
                               batch_stats=r["batch_stats"])
        stats = [k for k in want if "running" in k]
        assert len(stats) == 2 * 8 and all(k.startswith("extractor.") for k in stats)
        for k in stats:
            np.testing.assert_allclose(g["state"][k].numpy(), want[k].numpy(), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
            assert not torch.equal(g["state"][k], initial[k]), k
