"""The port's optimizers and its train step's counts against optax and the
JAX package's `make_train_step`, on a toy regression (a 4 x 3 weight and a
bias, loss sum((x W + b - y)^2) an item), with numpy-made inputs:

- each optimizer (`optim.py`) over five steps on the same gradients as
  optax's, parameters within 1e-6 relative (float32 in another order of
  the same operations);
- the lr after a skipped update: a non-finite loss planted at update 2 of 6,
  the port's lr at each update equal to its schedule at optax's count (the
  `ScaleByScheduleState` count read from JAX's `opt_state`), for `exp` and
  `cosine`, the parameters after six updates equal to JAX's;
- `grad_accumulation` 3 as optax.MultiSteps inside the NaN-skip: non-finite
  micro-batches planted in a 2nd and in a 3rd slot, the parameters, the
  update count and the micro-step count after 9 micro-batches equal to
  JAX's; and micro-batches whose own step would overflow a parameter at a
  huge lr kept before a finite K-th update (MultiSteps updates nothing on
  them), as in JAX.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gluefactory_tpu import train as jax_train
from gluefactory_tpu.core.config import Config as JConfig
from gluefactory_tpu_torch import optim
from gluefactory_tpu_torch import train as torch_train
from gluefactory_tpu_torch.core.config import Config, merge

RTOL = 1e-6

OPTAX = {"adam": optax.adam, "adamw": optax.adamw, "sgd": optax.sgd, "rmsprop": optax.rmsprop}
CASES = [
    ("adam", {}), ("adam", {"b1": 0.8, "b2": 0.99, "eps_root": 1e-8}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1}),
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {}), ("rmsprop", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"centered": True, "initial_scale": 0.5}),
    ("rmsprop", {"bias_correction": True, "eps_in_sqrt": False, "decay": 0.8}),
]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= RTOL, (what, err)


@pytest.mark.parametrize("name,opts", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_five_steps_match_optax(name, opts):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    grads[2]["b"][1] = 0.0
    lrs = [1e-2, 2e-2, 5e-3, 1e-2, 3e-2]  # a schedule: the lr of each step

    tx = OPTAX[name](lambda count: jnp.asarray(lrs)[count], **opts)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optim.OPTIMIZERS[name](list(tp.values()), lr=lrs[0], **opts)
    for lr, g in zip(lrs, grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.param_groups[0]["lr"] = torch.tensor(lr)  # a 0-dim tensor, as the trainer gives it
        opt.step()
    for k in params:
        _close(tp[k].detach(), jp[k], (name, k))
    assert {float(opt.state[p]["step"]) for p in tp.values()} == {5.0}


# ---------------------------------------------------------------------------
# the toy model in both packages
# ---------------------------------------------------------------------------


class JaxToy(nn.Module):
    def setup(self):
        self.w = self.param("w", nn.initializers.zeros, (4, 3))
        self.b = self.param("b", nn.initializers.zeros, (3,))

    def forward_with_loss(self, data):
        y = data["x"] @ self.w + self.b
        return {}, {"total": ((y - data["y"]) ** 2).sum(-1)}, {}


class TorchToy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward_with_loss(self, data, train=True, generator=None):
        y = data["x"] @ self.w + self.b
        return {}, {"total": ((y - data["y"]) ** 2).sum(-1)}, {}


def _batches(n, bad, seed=1):
    """n batches of 6 items; those at the indices in `bad` carry a NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.normal(size=(6, 4)).astype(np.float32)
        if i in bad:
            x[2, 1] = np.nan
        out.append({"x": x, "y": rng.normal(size=(6, 3)).astype(np.float32)})
    return out


def _init(seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)


def _schedule_count(opt_state) -> int:
    """optax's lr count: the ScaleByScheduleState's."""
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)]
    assert len(states) == 1
    return int(states[0].count)


def _run_jax(train, batches, w, b, steps_per_epoch):
    model = JaxToy()
    variables = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    tx, _ = jax_train.build_optimizer(JConfig(train.to_dict()), variables["params"], model,
                                      steps_per_epoch)
    opt_state = tx.init(variables["params"])
    step = jax.jit(jax_train.make_train_step(model, tx))
    counts, oks = [], []
    for batch in batches:
        counts.append(_schedule_count(opt_state))
        variables, opt_state, _, _, info = step(variables, opt_state, jax.tree.map(jnp.asarray, batch),
                                                jax.random.key(0))
        oks.append(bool(info["ok"]))
    return variables["params"], opt_state, counts, oks


def _run_torch(train, batches, w, b, steps_per_epoch):
    model = TorchToy(w, b)
    opt, schedule = torch_train.build_optimizer(train, model, steps_per_epoch)
    accum = int(train.grad_accumulation)
    step = torch_train.TrainStep(model, opt, schedule, accum=accum,
                                 max_updates=len(batches) // accum)
    lrs, oks = [], []
    for batch in batches:
        lrs.append(float(step.lr()))
        _, _, info = step({k: torch.from_numpy(v) for k, v in batch.items()})
        oks.append(bool(info["ok"]))
    return model, step, schedule, lrs, oks


SCHEDULES = {"exp": {"type": "exp", "start": 0, "exp_div_10": 1},
             "cosine": {"type": "cosine"}}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_lr_after_a_skipped_update_follows_optax_count(sched):
    train = merge(Config(torch_train.default_train_conf),
                  {"lr": 0.05, "epochs": 3, "lr_schedule": SCHEDULES[sched]})
    batches = _batches(6, bad={1})
    w, b = _init()
    steps_per_epoch = 2
    jparams, _, counts, joks = _run_jax(train, batches, w, b, steps_per_epoch)
    model, step, schedule, lrs, oks = _run_torch(train, batches, w, b, steps_per_epoch)
    assert oks == joks == [True, False, True, True, True, True]
    assert counts == [0, 1, 1, 2, 3, 4]
    assert lrs == [float(np.float32(schedule(c))) for c in counts]
    assert len(set(lrs)) == 5  # the schedule moves at every applied update
    jax_schedule = jax_train.build_lr_schedule(JConfig(train.to_dict()), steps_per_epoch)
    for lr, c in zip(lrs, counts):
        assert abs(lr - float(jax_schedule(c))) <= RTOL * 0.05
    assert step.updates == 5
    _close(model.w.detach(), jparams["w"], "w")
    _close(model.b.detach(), jparams["b"], "b")


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_grad_accumulation_skips_as_multisteps(name):
    train = merge(Config(torch_train.default_train_conf),
                  {"lr": 0.05, "epochs": 2, "optimizer": name, "grad_accumulation": 3,
                   "lr_schedule": {"type": "exp", "start": 0, "exp_div_10": 1}})
    # micro-batch 1 sits in the 2nd slot of the first update and 6 in the
    # 3rd slot of the second (after micro-batch 1 is undone)
    batches = _batches(9, bad={1, 6})
    w, b = _init()
    jparams, jstate, _, joks = _run_jax(train, batches, w, b, steps_per_epoch=6)
    model, step, _, _, oks = _run_torch(train, batches, w, b, steps_per_epoch=6)
    assert oks == joks == [i not in (1, 6) for i in range(9)]
    assert step.updates == int(jstate.gradient_step) == 2
    assert int(step.micro) == int(jstate.mini_step) == 1
    _close(model.w.detach(), jparams["w"], "w")
    _close(model.b.detach(), jparams["b"], "b")
    for acc, key in zip(step.acc, ("w", "b")):
        _close(acc, jstate.acc_grads[key], f"acc {key}")



def test_grad_accumulation_keeps_micro_batches_whose_own_step_would_overflow():
    """K = 3, SGD at lr 1e37: micro-batch 0's gradient alone (inputs 10x)
    would overflow a parameter, micro-batch 1's is its negation (targets
    mirrored about the prediction), so the mean of the three is small and
    the K-th update finite. MultiSteps keeps all three, as JAX does."""
    train = merge(Config(torch_train.default_train_conf),
                  {"lr": 1e37, "epochs": 1, "optimizer": "sgd", "grad_accumulation": 3})
    w, b = _init()
    batches = _batches(3, bad=set())
    x0 = batches[0]["x"] * np.float32(10)
    mirrored = 2.0 * (x0.astype(np.float64) @ w + b) - batches[0]["y"]
    batches[0]["x"] = batches[1]["x"] = x0
    batches[1]["y"] = mirrored.astype(np.float32)
    jparams, jstate, _, joks = _run_jax(train, batches, w, b, steps_per_epoch=3)
    model, step, _, _, oks = _run_torch(train, batches, w, b, steps_per_epoch=3)
    assert oks == joks == [True, True, True]
    assert step.updates == int(jstate.gradient_step) == 1
    assert int(step.micro) == int(jstate.mini_step) == 0
    for p in (model.w, model.b):
        assert torch.isfinite(p).all()
    _close(model.w.detach(), jparams["w"], "w")
    _close(model.b.detach(), jparams["b"], "b")


def test_lr_table_covers_the_run_and_keeps_its_last_lr_after():
    """The table holds the schedule at counts 0..max_updates; a step past
    them (more updates than the run planned) keeps the last lr."""
    train = merge(Config(torch_train.default_train_conf),
                  {"lr": 0.05, "epochs": 1, "lr_schedule": SCHEDULES["exp"]})
    w, b = _init()
    model = TorchToy(w, b)
    opt, schedule = torch_train.build_optimizer(train, model, 2)
    step = torch_train.TrainStep(model, opt, schedule, max_updates=2)
    assert step.lr_table.tolist() == [float(np.float32(schedule(c))) for c in range(3)]
    lrs = []
    for batch in _batches(5, bad=set()):
        lrs.append(float(step.lr()))
        assert bool(step({k: torch.from_numpy(v) for k, v in batch.items()})[2]["ok"])
    assert step.updates == 5
    assert lrs == [float(np.float32(schedule(c))) for c in (0, 1, 2, 2, 2)]
