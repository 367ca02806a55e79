"""The port's train step against the JAX package's `make_train_step`.

A small SuperPoint (channels [8, 8, 16, 16], frozen, random weights) +
LightGlue (3 layers, d = 64, 2 heads) pipeline with the homography ground
truth takes three Adam steps on the same three batches in both packages,
with LightGlue's `checkpointed` on and off. Every keypoint slot is a
detection (asserted), so neither package's random keypoint fill, whose
random streams differ, enters the result. Tolerances: losses within 1e-4
relative; step-0 gradients within 1e-4 of their global norm; parameters
after three steps within 3 * lr * steps absolute (Adam moves each parameter
by about lr a step, and a near-zero gradient may take either sign).

Also: a non-finite batch leaves parameters and optimizer state bit-equal,
`grad_accumulation = 2` equals one batch of twice the size, and the lr
schedule equals JAX's `build_lr_schedule`, fractional steps per epoch
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu import train as jax_train
from gluefactory_tpu.core.config import Config as JConfig
from gluefactory_tpu.models import get_model as jax_get_model
from gluefactory_tpu_torch import train as torch_train
from gluefactory_tpu_torch.compat.jax_params import from_jax_params
from gluefactory_tpu_torch.core.config import Config, merge
from gluefactory_tpu_torch.data.base_dataset import collate
from gluefactory_tpu_torch.data.homographies import HomographyDataset
from gluefactory_tpu_torch.models import get_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the file's tests and fixtures: the suite runs 6
    workers on the host's cores, and torch's default pool oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K, HEADS, LR, STEPS, B = 32, 2, 1e-3, 3, 2
MODEL = {
    "name": "two_view_pipeline",
    "extractor": {"name": "superpoint", "channels": [8, 8, 16, 16], "head_channels": 32,
                  "descriptor_dim": 64, "max_num_keypoints": K, "force_num_keypoints": True,
                  "detection_threshold": 0.0, "nms_radius": 3, "trainable": False},
    "ground_truth": {"name": "homography_matcher", "th_positive": 3, "th_negative": 3},
    "matcher": {"name": "lightglue", "input_dim": 64, "descriptor_dim": 64, "n_layers": 3,
                "num_heads": HEADS, "filter_threshold": 0.1, "flash": False},
}
TRAIN = {"lr": LR, "lr_schedule": {"type": "exp", "start": 0.0, "exp_div_10": 2}}
DATA = {"synthetic_images": 16, "train_size": 8, "val_size": 2, "source_size": [96, 80],
        "homography": {"patch_shape": [80, 64], "difficulty": 0.5, "max_angle": 30},
        "photometric": {"name": "identity"}}
STEPS_PER_EPOCH = 4


def make_batches(n=STEPS, batch=B, offset=0):
    ds = HomographyDataset(DATA).get_dataset("train")
    out = []
    for i in range(n):
        items = [ds[offset + i * batch + j] for j in range(batch)]
        out.append({k: v for k, v in collate(items).items() if k not in ("name", "idx")})
    return out


def to_jax(batch):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), batch)


def model_conf(checkpointed):
    return merge(Config(MODEL), {"matcher": {"checkpointed": checkpointed}}).to_dict()


def train_conf(**kw):
    return merge(Config(torch_train.default_train_conf), TRAIN, kw)


def port_model(params, checkpointed):
    conf = model_conf(checkpointed)
    model = get_model("two_view_pipeline").from_conf(
        {k: v for k, v in conf.items() if k != "name"}, device="cpu")
    model.load_state_dict(from_jax_params(params, "two_view_pipeline", num_heads=HEADS))
    return model


@pytest.fixture(scope="module")
def jax_run():
    """JAX: initial params, step-0 gradients, and per checkpointed setting
    the losses of three steps and the final params (one initialisation:
    `nn.remat` keeps the parameter names)."""
    batches = make_batches()
    jb = [to_jax(b) for b in batches]
    out = {"batches": batches}
    key = jax.random.key(0)
    for checkpointed in (False, True):
        conf = model_conf(checkpointed)
        model = jax_get_model("two_view_pipeline").from_conf(
            {k: v for k, v in conf.items() if k != "name"})
        if not checkpointed:
            variables = jax.jit(model.init, static_argnames="method")(
                {"params": key, "sample": key}, jb[0], method="initialize")
            params = variables["params"]

            def loss_fn(p):
                outs, _ = model.apply({"params": p}, jb[0], method="forward_with_loss",
                                      mutable=["batch_stats"], rngs={"sample": key})
                return outs[1]["total"].mean()

            out["params"] = jax.tree.map(np.asarray, params)
            out["grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))
        tconf = JConfig(train_conf().to_dict())
        tx, _ = jax_train.build_optimizer(tconf, params, model, STEPS_PER_EPOCH)
        opt_state = tx.init(params)
        step = jax.jit(jax_train.make_train_step(model, tx))
        variables = {"params": params}
        losses = []
        for b in jb:
            variables, opt_state, ls, _, info = step(variables, opt_state, b, key)
            assert bool(info["ok"])
            losses.append({k: float(v) for k, v in ls.items()})
        out[checkpointed] = {"losses": losses,
                             "final": jax.tree.map(np.asarray, variables["params"])}
    return out


def test_every_keypoint_slot_is_a_detection(jax_run):
    model = port_model(jax_run["params"], False)
    for batch in jax_run["batches"]:
        with torch.no_grad():
            pred = model(batch)
        for i in "01":
            assert (pred[f"keypoint_scores{i}"] > 0).all(), "a keypoint slot was filled at random"


@pytest.mark.parametrize("checkpointed", [False, True])
def test_three_steps_match_jax(jax_run, checkpointed):
    ref = jax_run[checkpointed]
    model = port_model(jax_run["params"], checkpointed)
    opt, schedule = torch_train.build_optimizer(train_conf(), model, STEPS_PER_EPOCH)
    step = torch_train.TrainStep(model, opt, schedule, max_updates=STEPS)
    for i, (batch, want) in enumerate(zip(jax_run["batches"], ref["losses"])):
        losses, _, info = step(batch, torch.Generator().manual_seed(i))
        assert bool(info["ok"])
        for k, v in want.items():
            got = float(losses[k])
            assert abs(got - v) <= 1e-4 * max(abs(v), 1.0), (i, k, got, v)
        if i == 0 and not checkpointed:
            grads = from_jax_params(jax_run["grads"], "two_view_pipeline", num_heads=HEADS)
            gnorm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())))
            for name, p in model.named_parameters():
                if p.requires_grad:
                    err = float((p.grad - grads[name]).abs().max())
                    assert err <= 1e-4 * gnorm, (name, err, gnorm)
    want = from_jax_params(ref["final"], "two_view_pipeline", num_heads=HEADS)
    for name, p in model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 3 * LR * STEPS, (name, err)


def _snapshot(model, opt):
    state = {id(p): {k: v.clone() for k, v in opt.state[p].items() if torch.is_tensor(v)}
             for p in opt.state}
    return {n: p.detach().clone() for n, p in model.state_dict().items()}, state


def test_non_finite_batch_leaves_everything_bit_equal(jax_run):
    model = port_model(jax_run["params"], False)
    opt, schedule = torch_train.build_optimizer(train_conf(), model, STEPS_PER_EPOCH)
    step = torch_train.TrainStep(model, opt, schedule, max_updates=3)
    good, bad = jax_run["batches"][0], dict(jax_run["batches"][1])
    bad["view1"] = {**bad["view1"], "image": torch.full_like(bad["view1"]["image"], float("nan"))}
    for first in (True, False):  # before any state exists, then after a good step
        if not first:
            assert bool(step(good)[2]["ok"])
        params, state = _snapshot(model, opt)
        losses, _, info = step(bad)
        assert not bool(info["ok"]) and not np.isfinite(float(losses["total"]))
        for n, p in model.state_dict().items():
            assert torch.equal(p, params[n]), n
        for p in opt.state:
            for k, v in opt.state[p].items():
                if torch.is_tensor(v):
                    want = state.get(id(p), {}).get(k, torch.zeros_like(v))
                    assert torch.equal(v, want), k
    assert bool(step(good)[2]["ok"])


def test_grad_accumulation_equals_a_double_batch(jax_run):
    """SGD, so that the update is linear in the gradient: the gradient the
    optimizer gets within 1e-5 of its global norm, the parameters within
    1e-6 (float32 sums in another order)."""
    params = jax_run["params"]
    b0, b1 = jax_run["batches"][:2]
    double = jax.tree.map(lambda a, b: torch.cat([a, b]), b0, b1)
    results = []
    for accum, batches in ((2, [b0, b1]), (1, [double])):
        model = port_model(params, False)
        conf = train_conf(grad_accumulation=accum, optimizer="sgd")
        opt, schedule = torch_train.build_optimizer(conf, model, STEPS_PER_EPOCH)
        step = torch_train.TrainStep(model, opt, schedule, accum=accum, max_updates=1)
        for b in batches:
            assert bool(step(b)[2]["ok"])
        assert step.updates == 1
        results.append({n: (p.detach(), p.grad) for n, p in model.named_parameters()
                        if p.requires_grad})
    gnorm = float(torch.linalg.vector_norm(torch.stack([g.norm() for _, g in results[1].values()])))
    for n, (p, g) in results[0].items():
        p2, g2 = results[1][n]
        assert float((g - g2).abs().max()) <= 1e-5 * gnorm, n
        assert float((p - p2).abs().max()) <= 1e-6, n


SCHEDULES = [
    {"type": "exp", "start": 2, "exp_div_10": 3},
    {"type": "exp", "start": 0, "exp_div_10": 10, "unit": "iter"},
    {"type": "factor", "on_epoch": [1, 2.5], "factor": 0.5},
    {"type": "cosine"},
    [{"type": "exp", "start": 1, "exp_div_10": 4}, {"type": "factor", "on_epoch": [3], "factor": 0.1}],
    {"type": None},
]


@pytest.mark.parametrize("sconf", SCHEDULES, ids=range(len(SCHEDULES)))
@pytest.mark.parametrize("steps_per_epoch", [3, 2.5, 0.5])
def test_lr_schedule_matches_jax(sconf, steps_per_epoch):
    conf = {"lr": "1e-3", "epochs": 4, "lr_schedule": sconf}
    mine = torch_train.build_lr_schedule(Config(conf), steps_per_epoch)
    ref = jax_train.build_lr_schedule(JConfig(conf), steps_per_epoch)
    for step in range(0, 25):
        want = float(ref(step))
        # JAX computes in float32: 1 + cos near pi cancels to ~1e-6 of the base lr
        assert abs(mine(step) - want) <= 1e-6 * 1e-3, (step, mine(step), want)
