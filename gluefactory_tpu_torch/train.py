"""Training engine on one CUDA device (counterpart of `gluefactory_tpu/train.py`).

    python -m gluefactory_tpu_torch.train <experiment> --conf <yaml> [dotlist]
        [--device cuda|cpu] [--overfit] [--restore] [--no_tensorboard]
        [--max_val_iters N] [--detect_anomaly] [--profile] [--no_capture]

A train step is the forward with the loss (ground truth on the device in the
pipeline's loss), the backward, and the optimizer update with the JAX
package's NaN-skip, all without a host read: a gradient tensor with any
non-finite entry is zeroed, the update applied, and the parameters and the
whole optimizer state put back with `torch.where` if the loss or any
updated parameter is not finite. The optimizers are optax's (`optim.py`);
the count of applied updates lives on the device and looks the lr up in a
table of the schedule, so a skipped update does not advance it. The host
reads the losses and the lr only where it logs (`log_every_iter`) and at
evaluation.

Frozen components (`trainable: False`) have no gradient and are not in the
optimizer; `opt_regexp` keeps in the optimizer only the parameters whose
torch name matches it. `grad_accumulation` K runs optax.MultiSteps inside
the NaN-skip: the running mean of K kept micro-batches makes one update,
and the lr schedule counts real updates, in the epoch fraction
`updates / (steps_per_epoch / K)`.

`mixed_precision: bf16` runs the forward and the backward on bf16 copies of
every float32 parameter (the frozen ones too) and of the views' images, as
the JAX package does: the casts are in the graph, so the gradients come
back in float32 onto the float32 parameters, which the NaN-skip, the
accumulation and the optimizer then treat as in float32 training. The loss
is taken in whatever dtype the model gives it.

`run_benchmarks` runs each named benchmark (`eval.run_benchmark`) at the
end of every epoch on the model in memory, with its conf from
`benchmark_conf.<name>`, into `<output_dir>/benchmarks/<name>`, and writes
its scalar summaries to the writer; a benchmark that fails is logged and
training goes on, as in the JAX package: `hpatches`, `megadepth1500`,
`scannet1500`, `eth3d` and `zeb`.

Models with BatchNorm in training mode (SuperGlue) update their running
statistics in the forward; the NaN-skip restores only the trained tensors
and the optimizer state, so a rejected step keeps that update, as the JAX
trainer keeps its `batch_stats`. Checkpoints hold the statistics (they are
in the model's state dict), and validation (`train=False`) normalises by
them.

`device_augment` (a dict: `patch_size`, `difficulty`, `translation`,
`photometric_strength`, `n_angles`, `max_angle`, with the JAX package's
defaults) makes the two views of a batch of `source_image`s (the homography
dataset's `emit_source`) inside the train step, on the batch's device,
before the forward (`data/device_homography.py`), and in each validation
batch. Its keys follow the JAX trainer's chain (`augment_keys`), so a
step's batch is JAX's; the model's own sampling keeps the torch generator.

`steps_per_dispatch` K makes K loader batches one dispatch (the tail padded
with the last batch): K train steps back to back, with no host read between
them, as JAX's one scanned dispatch. `total_iter` counts dispatches; the
log fires where `it % log_every_iter < K`, with the last step's losses and
the lr at `schedule(total_iter * K)` in micro-steps (`// grad_accumulation`
in updates), as the JAX trainer logs it, and each dispatch adds K batches to
the samples.

Data-parallel training (`utils/distributed.py`) has the semantics of the
JAX trainer's pjit step over a sharded batch: a rank's result is its slice
of the one-process result on the global batch. Launched by torchrun
(`torchrun --nproc_per_node=N -m gluefactory_tpu_torch.train ...`), every
process joins the group of its environment (NCCL on `cuda:LOCAL_RANK`,
gloo with `--device cpu`); `--n_devices`, where given, must equal the
group's size. With more than one rank each loads its shard of every split
(`DistributedSampler`, `set_epoch` every epoch) and `data.batch_size`
items a step, as each JAX process loads its own. The gradients of every
micro-batch, and its loss, are all-reduced to their mean in one flat
buffer before the NaN-skip, so the skip and the lr count agree on every
rank; BatchNorm's batch statistics are the global batch's; random draws
for the batch (the keypoint fill, `device_augment`) are made for the global
batch and sliced. Logged losses and validation results are the global
batch's. Rank 0 alone writes the log, the writer, the config and the
checkpoints; `--restore` loads on every rank.

`plot: [every, "<dotted path>"]` draws figures to the writer (only with
one) in the evaluation of every `every`-th `eval_every_iter` window:
`plot_hook` runs the model in train mode on the dispatch's last batch and
sends what the figure function gives to `figures/<name>`. With a writer the
path is resolved before training starts, and one that does not resolve, or
names the JAX package, raises `ValueError`. The hook leaves the model's
buffers and every generator as it found them, so a run trains bit for bit
as without it; a figure function that raises (ImportError without
matplotlib) is logged and training goes on.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import pydoc
import re
import signal
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from . import logger
from .core.config import Config, from_dotlist, from_yaml, merge
from .data import get_dataset
from .data.base_dataset import prepare_batch
from .eval.io import parse_config_path
from .models import get_model
from .optim import OPTIMIZERS
from .settings import TRAINING_PATH
from .utils import distributed, threefry
from .utils.experiments import (
    delete_old_checkpoints,
    get_best_checkpoint,
    get_last_checkpoint,
    load_checkpoint,
    save_checkpoint,
    update_best_checkpoint,
)
from .utils.tools import AverageMetric, MedianMetric, PRMetric, RecallMetric, set_seed

default_train_conf = {
    "seed": 0,
    "epochs": 1,
    "optimizer": "adam",  # adam | adamw | sgd | rmsprop
    "optimizer_options": {},
    "opt_regexp": None,  # only parameters whose torch name matches are trained
    "lr": 0.001,
    "lr_schedule": {"type": None, "start": 0, "exp_div_10": 0, "factor": 1.0,
                    "on_epoch": [], "unit": "epoch"},
    "lr_scaling": [],
    "eval_every_iter": 1000,
    "save_every_iter": 5000,
    "log_every_iter": 200,
    "keep_last_checkpoints": 5,
    "load_experiment": None,  # warm start from another experiment's best checkpoint
    "median_metrics": [],
    "recall_metrics": {},
    "pr_curves": {},
    "pr_metrics": {},
    "best_key": "loss/total",
    "dataset_callback_fn": None,
    "dataset_callback_on_val": False,
    "clip_grad": None,
    "mixed_precision": None,
    "log_it": False,
    "steps_per_dispatch": 1,
    "grad_accumulation": 1,
    "device_augment": None,
    "log_grad_every_iter": None,
    "plot": None,
    "run_benchmarks": [],
    "benchmark_conf": {},
}

default_conf = {"data": {}, "model": {}, "train": default_train_conf}


# ---------------------------------------------------------------------------
# lr schedule and optimizer
# ---------------------------------------------------------------------------


def _apply_one_schedule(sconf, conf, steps_per_epoch, step, epoch, lr: float) -> float:
    """The multiplier of one schedule conf applied to the running lr."""
    stype = sconf.get("type")
    if stype in (None, "none"):
        return lr
    t = step if sconf.get("unit", "epoch") == "iter" else epoch
    if stype == "exp":
        gam = 10.0 ** (-1.0 / max(sconf.get("exp_div_10", 0) or 1e-9, 1e-9))
        return lr * gam ** max(t - sconf.get("start", 0), 0.0)
    if stype == "factor":
        on = list(sconf.get("on_epoch") or [])
        return lr * sconf.get("factor", 1.0) ** sum(t >= e for e in on) if on else lr
    if stype == "cosine":
        total = conf.epochs * steps_per_epoch
        return lr * 0.5 * (1 + math.cos(math.pi * min(step / max(total, 1), 1.0)))
    fn = pydoc.locate(str(stype))  # a dotted path to fn(step, epoch, lr, sconf) -> lr
    if fn is None:
        raise ValueError(f"unknown lr schedule type or path: {stype!r}")
    return fn(step, epoch, lr, sconf)


def build_lr_schedule(conf, steps_per_epoch: float):
    """step -> lr, in Python floats: `exp` (10x down every `exp_div_10`
    epochs from `start`), `factor` (times `factor` at each epoch of
    `on_epoch`), `cosine`, or a dotted path; a list of confs is chained.
    `unit: iter` counts steps instead of epochs. The epoch is the fraction
    step / steps_per_epoch, which may itself be fractional."""
    sconf = conf.lr_schedule
    chain = list(sconf) if isinstance(sconf, (list, tuple)) else [sconf]

    def schedule(step) -> float:
        epoch = step / max(steps_per_epoch, 1e-9)
        lr = float(conf.lr)
        for sc in chain:
            lr = _apply_one_schedule(sc, conf, steps_per_epoch, step, epoch, lr)
        return lr

    return schedule


def trained_parameters(conf, model) -> list:
    """(name, parameter) of the parameters the optimizer updates: those
    with a gradient (frozen components have none) whose name matches
    `opt_regexp` if set."""
    regexp = re.compile(conf.opt_regexp) if conf.opt_regexp else None
    return [(n, p) for n, p in model.named_parameters()
            if p.requires_grad and (regexp is None or regexp.search(n))]


def build_optimizer(conf, model, steps_per_epoch: int):
    """(optimizer, schedule): the optimizer over `trained_parameters`, and
    the lr schedule in real updates (steps_per_epoch / grad_accumulation a
    data epoch). The optimizers are optax's (`optim.py`), with optax's option
    names and defaults; their state lives on the parameters' device."""
    accum = int(conf.get("grad_accumulation") or 1)
    schedule = build_lr_schedule(conf, steps_per_epoch / accum)
    named = trained_parameters(conf, model)
    params = [p for _, p in named]
    if not params:
        raise ValueError("no parameter to train")
    if conf.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {conf.optimizer}")
    opt = OPTIMIZERS[conf.optimizer](params, lr=float(conf.lr), **dict(conf.optimizer_options or {}))
    n_total = sum(1 for _ in model.parameters())
    logger.info("Optimizer: %d/%d parameter tensors trainable", len(params), n_total)
    return opt, schedule


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


class _ForwardBackward(torch.nn.Module):
    """forward_with_loss, then the backward of the mean total loss, in one
    call: under `torch.func.functional_call` the backward, and the
    recompute of checkpointed layers in it, then sees the parameters the
    forward saw."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch: dict, generator):
        _, losses, metrics = self.model.forward_with_loss(batch, train=True, generator=generator)
        losses["total"].mean().backward()
        return losses, metrics


def bf16_batch(batch: dict) -> dict:
    """The batch with the float32 `image` of each view cast to bf16."""
    batch = dict(batch)
    for view in ("view0", "view1", "view2"):
        if view in batch and "image" in batch[view] and batch[view]["image"].dtype == torch.float32:
            batch[view] = {**batch[view], "image": batch[view]["image"].to(torch.bfloat16)}
    return batch


def _all_finite(tensors) -> torch.Tensor:
    """0-dim bool: every entry of every tensor is finite (a NaN or inf makes
    the tensor's max-abs norm non-finite)."""
    return torch.isfinite(torch.stack(torch._foreach_norm(tensors, float("inf")))).all()


class TrainStep:
    """One call is one micro-batch: forward with loss (`train=True`),
    backward, and an optimizer update with the NaN-skip. Returns (losses,
    metrics, info) as device tensors: the batch means, `grad_norm` (the
    global norm of the raw gradients) and `ok` (the micro-batch was kept).

    As optax computes it, with every count on the device: `count`, the
    updates applied, indexes `lr_table` (the schedule at counts 0 to
    `max_updates`, the updates the run can make; a later count keeps the
    last lr) for the lr, and advances only with an applied update. Under
    `grad_accumulation` K, as optax.MultiSteps inside the NaN-skip: each
    micro-batch folds its gradients into the running mean `acc` and the
    optimizer steps on that mean; the step is kept only at the K-th
    (`micro` == K - 1), and a micro-batch whose loss is not finite, or whose
    K-th step makes a parameter non-finite, leaves parameters, optimizer
    state, `micro` and `acc` as they were. `mixed_precision="bf16"` runs
    the forward and backward on bf16 copies of the float32 parameters and
    of the views' images. With `device_augment`, a batch of `source_image`s
    becomes its two views (`apply_device_augment`) on `key` first. With a
    data-parallel `group`, the forward runs `sharded` over it and the
    gradients and the loss are all-reduced to their global mean before
    anything reads them, so `grad_norm`, the NaN-skip and `ok` are the
    global batch's on every rank."""

    def __init__(self, model, optimizer, schedule, accum: int = 1, clip_grad=None, *,
                 max_updates: int, mixed_precision=None, device_augment=None,
                 group: distributed.Group | None = None):
        if mixed_precision not in (None, "bf16"):
            raise NotImplementedError(f"mixed_precision {mixed_precision!r} is not ported")
        self.model = model
        self.mixed_precision = mixed_precision
        self.device_augment = device_augment
        self.group = group
        self._forward_backward = _ForwardBackward(model)
        self.optimizer = optimizer
        self.schedule = schedule
        self.accum = int(accum)
        self.clip_grad = clip_grad
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.trained = [p for g in optimizer.param_groups for p in g["params"]]
        dev = self.trained[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.micro = torch.zeros((), dtype=torch.int64, device=dev)
        self.acc = [torch.zeros_like(p) for p in self.trained] if self.accum > 1 else []
        self.lr_table = torch.tensor([schedule(i) for i in range(int(max_updates) + 1)],
                                     dtype=torch.float32, device=dev)

    def lr(self) -> torch.Tensor:
        """The lr of the next update (0-dim, on the device). `index_select`:
        indexing with a 0-dim tensor would read it on the host."""
        last = len(self.lr_table) - 1
        return self.lr_table.index_select(0, self.count.clamp(max=last).view(1)).view(())

    @property
    def updates(self) -> int:
        """The updates applied so far (a host read)."""
        return int(self.count)

    def state_dict(self) -> dict:
        return {"updates": self.count, "micro": self.micro, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.count.copy_(torch.as_tensor(state["updates"]))
        self.micro.copy_(torch.as_tensor(state.get("micro", 0)))
        for a, b in zip(self.acc, state.get("acc", [])):
            a.copy_(b)

    def __call__(self, batch: dict, generator: torch.Generator | None = None, key=None):
        with distributed.sharded(self.group):
            if self.device_augment and "source_image" in batch:
                batch = apply_device_augment(batch, key, self.device_augment)
            for p in self.params:
                p.grad = None
            if self.mixed_precision == "bf16":
                cast = {"model." + n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                        for n, p in self.model.named_parameters()}
                losses, metrics = torch.func.functional_call(self._forward_backward, cast,
                                                             (bf16_batch(batch), generator))
            else:
                losses, metrics = self._forward_backward(batch, generator)
        loss = losses["total"].detach().mean()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.group is not None:  # one all-reduce: the global batch's gradients and loss
            *grads, loss = distributed.all_reduce_mean(grads + [loss], self.group)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # a gradient tensor with any non-finite entry is zeroed
        safe = {p: torch.where(torch.isfinite(n), g, torch.zeros_like(g))
                for p, g, n in zip(self.params, grads, torch._foreach_norm(grads, float("inf")))}
        grads = [safe[p] for p in self.trained]
        emit = None
        if self.accum > 1:  # optax.MultiSteps' running mean, then its K-th step
            step = torch._foreach_div(torch._foreach_sub(grads, self.acc),
                                      (self.micro + 1).to(grads[0].dtype))
            grads = torch._foreach_add(self.acc, step)
            emit = self.micro == self.accum - 1
        ok = self._update(grads, torch.isfinite(loss), emit)
        losses = {k: v.detach().mean() for k, v in losses.items()}
        metrics = {k: v.detach().float().mean() for k, v in metrics.items()}
        return losses, metrics, {"grad_norm": grad_norm.detach(), "ok": ok}

    def _optimizer_tensors(self) -> list:
        """(param, key, tensor) of the optimizer's state tensors."""
        return [(p, k, v) for p in self.trained for k, v in self.optimizer.state.get(p, {}).items()
                if torch.is_tensor(v)]

    def _update(self, grads, loss_ok, emit) -> torch.Tensor:
        """One optimizer step on `grads` at the lr of `count`; kept (and
        `count` advanced) where the loss and every updated parameter are
        finite and, under accumulation, `emit`; else undone on the device.
        Returns `ok`: the loss is finite and, where the step is kept, so is
        every updated parameter (MultiSteps' other micro-batches update
        nothing, so their parameters stay finite)."""
        old_params = [p.detach().clone() for p in self.trained]
        old_state = [(v, v.clone()) for _, _, v in self._optimizer_tensors()]
        clipped = grads
        if self.clip_grad is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_grad, 1.0, self.clip_grad / norm)
            clipped = torch._foreach_mul(grads, scale)
        for p, g in zip(self.trained, clipped):
            p.grad = g
        lr = self.lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        with torch.no_grad():
            params_ok = _all_finite(self.trained)
            ok = loss_ok & (params_ok if emit is None else params_ok | ~emit)
            keep = ok if emit is None else ok & emit
            for p, old in zip(self.trained, old_params):
                p.copy_(torch.where(keep, p, old))
            for v, old in old_state:
                v.copy_(torch.where(keep, v, old))
            self.count += keep
            if emit is not None:
                for a, g in zip(self.acc, grads):
                    a.copy_(torch.where(ok, torch.where(emit, 0.0, g), a))
                self.micro = torch.where(ok, torch.where(emit, 0, self.micro + 1), self.micro)
        return ok


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def apply_device_augment(batch: dict, key, device_augment) -> dict:
    """The batch with its `source_image`s replaced by two homography views
    and `H_0to1` (`generate_homography_pairs` on `key`, the conf's settings
    with the JAX package's defaults; under data parallelism this rank's
    rows of the global batch's draws)."""
    from .data.device_homography import generate_homography_pairs

    with torch.no_grad():
        gen = generate_homography_pairs(
            batch["source_image"], key,
            patch_size=tuple(device_augment.get("patch_size", (640, 480))),
            difficulty=device_augment.get("difficulty", 0.5),
            translation=device_augment.get("translation", 1.0),
            photometric_strength=device_augment.get("photometric_strength", 0.5),
            n_angles=device_augment.get("n_angles", 10),
            max_angle=device_augment.get("max_angle", 90.0), shard=distributed.batch_shard())
    return {**{k: v for k, v in batch.items() if k != "source_image"}, **gen}


def train_key(seed: int) -> torch.Tensor:
    """The JAX trainer's `rng_key` after its init draws: the third of
    `split(key(seed), 3)`."""
    return threefry.split(seed, 3)[2]


def augment_keys(rng_key, total_iter: int, k: int) -> list:
    """The augmentation key of each of dispatch `total_iter`'s k steps, as
    the JAX trainer derives them: `step_rng = fold_in(rng_key, total_iter)`,
    split k ways under k > 1, and each step's key the second of its split."""
    step_rng = threefry.fold_in(rng_key, total_iter)
    rngs = [step_rng] if k == 1 else list(threefry.split(step_rng, k))
    return [threefry.split(r)[1] for r in rngs]


def eval_key(rng_key) -> torch.Tensor:
    """The augmentation key of every validation batch: `fold_in(rng_key, 7)`."""
    return threefry.fold_in(rng_key, 7)


def do_evaluation(model, loader, conf, device, seed: int, max_iters=None, augment=None,
                  group: distributed.Group | None = None):
    """Validation loop (`train=False`) with streaming accumulators: losses
    under `loss/`, metrics, medians and recalls as `conf` asks, and the PR
    curves' (labels, predictions). Every batch draws its random keypoint
    fill from a generator seeded with `seed`. `augment`: (device_augment
    conf, key), applied to every batch of `source_image`s. With a `group`
    of several ranks, each batch's numbers are gathered from every rank (in
    rank order) before they are accumulated, so every rank returns the
    global results. Returns (results, pr_results)."""
    gather = group is not None and group.world > 1
    accums = {}
    pr_accums = defaultdict(PRMetric)
    gen = torch.Generator(device=device)
    with torch.no_grad():
        for i, batch in enumerate(loader):
            if max_iters is not None and i >= max_iters:
                break
            batch = prepare_batch(batch, device)
            with distributed.sharded(group):
                if augment and "source_image" in batch:
                    batch = apply_device_augment(batch, augment[1], augment[0])
                pred, losses, metrics = model.forward_with_loss(batch, train=False,
                                                                generator=gen.manual_seed(seed))
            curves = {name: [pred[spec["labels"]], pred[spec["predictions"]],
                             pred[spec["mask"]] if "mask" in spec else None]
                      for name, spec in (conf.pr_curves or {}).items()}
            numbers = {**{f"loss/{k}": v for k, v in losses.items()}, **metrics}
            numbers = {k: v.detach().float().cpu().numpy() for k, v in numbers.items()}
            if gather:
                curves = {k: [None if t is None else t.cpu() for t in c] for k, c in curves.items()}
                ranks = distributed.gather_rank_major((numbers, curves))
                numbers = {k: np.concatenate([r[0][k] for r in ranks]) for k in numbers}
                curves = {k: [None if c[i] is None else torch.cat([r[1][k][i] for r in ranks])
                              for i in range(3)] for k, c in curves.items()}
            for name, (labels, predictions, mask) in curves.items():
                pr_accums[name].update(labels, predictions, mask=mask)
            for k, v in numbers.items():
                if k not in accums:
                    if k in conf.median_metrics:
                        accums[k] = MedianMetric()
                        accums[k + "_median"] = MedianMetric()
                    elif k in conf.recall_metrics:
                        accums[k] = RecallMetric(conf.recall_metrics[k])
                    else:
                        accums[k] = AverageMetric()
                accums[k].update(v)
                if k + "_median" in accums:
                    accums[k + "_median"].update(v)
    return ({k: m.compute() for k, m in accums.items()},
            {k: m.compute() for k, m in pr_accums.items()})


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


class SigIntHandler:
    """Stop after the current iteration on SIGINT; a second SIGINT kills."""

    def __init__(self):
        self.stop = False
        self._prev = None

    def __enter__(self):
        def handler(sig, frame):
            if self.stop:
                raise KeyboardInterrupt
            logger.info("SIGINT: will stop after this iteration (again to kill).")
            self.stop = True

        self._prev = signal.signal(signal.SIGINT, handler)
        return self

    def __exit__(self, *a):
        signal.signal(signal.SIGINT, self._prev)


def generator_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1)[0])


def step_generator(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
    """`generator` reseeded from (seed, step)."""
    return generator.manual_seed(generator_seed(seed, step))


def dispatch(step: TrainStep, batches: list, generators: list, keys: list | None = None):
    """One dispatch: a train step on each batch in turn, with its generator
    and augmentation key, no host read in between; the last step's (losses,
    metrics, info)."""
    for i, batch in enumerate(batches):
        out = step(batch, generators[i]) if keys is None else step(batch, generators[i], keys[i])
    return out


def check_supported(conf, args, group: distributed.Group | None = None) -> None:
    """Raise on the options that are not ported yet, and on `--n_devices`
    that is not the process group's size (1 without a group)."""
    t = conf.train
    world = 1 if group is None else group.world
    if args.n_devices is not None and args.n_devices != world:
        if group is None:
            raise ValueError(f"--n_devices {args.n_devices}: one process trains on one device; launch "
                             f"{args.n_devices} processes with torchrun --nproc_per_node="
                             f"{args.n_devices} -m gluefactory_tpu_torch.train ...")
        raise ValueError(f"--n_devices {args.n_devices} is not the process group's size {world}")
    if t.mixed_precision not in (None, "bf16"):
        raise NotImplementedError(f"mixed_precision {t.mixed_precision!r} is not ported")
    for name in t.run_benchmarks or []:
        if name not in ("hpatches", "megadepth1500", "scannet1500", "eth3d", "zeb"):
            raise NotImplementedError(f"benchmark {name}: the port has no such benchmark")


def training(conf: Config, output_dir: Path, args):
    """Train `conf.model` on `conf.data` into `output_dir`; returns the model.
    Under torchrun, data-parallel over the environment's process group."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to train on the CPU")
    group = distributed.setup(device)
    check_supported(conf, args, group)
    main_rank = group is None or group.is_main
    shard = group is not None and group.world > 1  # each rank loads its shard
    world = 1 if group is None else group.world
    if group is not None:
        device = group.device
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    seed = conf.train.seed
    gen = set_seed(seed, device)
    writer = None
    if not args.no_tensorboard and main_rank:
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(str(output_dir))
        except ImportError:
            pass
    plot = resolve_plot(conf.train.plot) if writer is not None else None

    # data
    dataset = get_dataset(conf.data.name)(conf.data)
    pin = device.type == "cuda"
    if args.overfit:
        train_loader = dataset.get_overfit_loader("train", pin_memory=pin)
        val_loader = dataset.get_overfit_loader("val", pin_memory=pin)
    else:
        train_loader = dataset.get_data_loader("train", distributed=shard, pin_memory=pin)
        val_loader = dataset.get_data_loader("val", distributed=shard, pin_memory=pin)
    steps_per_epoch = max(len(train_loader), 1)
    logger.info("Training loader has %d batches", steps_per_epoch)

    # model and optimizer
    model = get_model(conf.model.name).from_conf(
        {k: v for k, v in conf.model.to_dict().items() if k != "name"}, device=device)
    logger.info("Model has %.2fM parameters", sum(p.numel() for p in model.parameters()) / 1e6)
    optimizer, schedule = build_optimizer(conf.train, model, steps_per_epoch)
    clip = conf.train.clip_grad
    accum = int(conf.train.grad_accumulation)
    k_steps = max(int(conf.train.steps_per_dispatch), 1)
    augment = conf.train.device_augment or None
    micro_per_epoch = math.ceil(steps_per_epoch / k_steps) * k_steps  # the tail padded
    step = TrainStep(model, optimizer, schedule, accum, None if clip is None else float(clip),
                     max_updates=math.ceil(conf.train.epochs * micro_per_epoch / accum),
                     mixed_precision=conf.train.mixed_precision, device_augment=augment,
                     group=group)
    rng_key = train_key(seed)

    epoch0, total_iter, best_eval = 0, 0, None
    if args.restore:
        ckpt_path = get_last_checkpoint(output_dir.name)
        payload = load_checkpoint(ckpt_path, map_location=device)
        model.load_state_dict(payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        step.load_state_dict(payload["step"])
        epoch0, total_iter = payload["epoch"] + 1, payload["iter"]
        logger.info("Restored from %s at epoch %d", ckpt_path, epoch0)
    elif conf.train.load_experiment:
        payload = load_checkpoint(get_best_checkpoint(conf.train.load_experiment), map_location=device)
        # every tensor of the model from the checkpoint; a tensor the model
        # lacks is skipped (stage 1's inter-layer line projections of
        # GlueStick, which stage 2 does not supervise), as flax's
        # `from_state_dict` skips it
        missing, unexpected = model.load_state_dict(payload["model"], strict=False)
        if missing:
            raise KeyError(f"load_experiment {conf.train.load_experiment}: the checkpoint lacks {missing}")
        if unexpected:
            logger.info("Warm start: skipped %d tensors the model lacks: %s", len(unexpected),
                        ", ".join(unexpected))
        logger.info("Warm-started from experiment %s", conf.train.load_experiment)
    if main_rank:
        (output_dir / "config.yaml").write_text(conf.to_yaml())

    stop = False
    results: dict = {}
    train_bs = dataset.batch_size("train")
    with SigIntHandler() as sig:
        for epoch in range(epoch0, conf.train.epochs):
            if stop:
                break
            cb = conf.train.dataset_callback_fn
            if cb and hasattr(dataset, cb):
                getattr(dataset, cb)(seed + epoch)
                train_loader = dataset.get_data_loader("train", distributed=shard and not args.overfit,
                                                       pin_memory=pin)
            dataset.epoch = epoch
            sampler = getattr(train_loader, "sampler", None)
            if hasattr(sampler, "set_epoch"):  # a new order every epoch
                sampler.set_epoch(epoch)
            t_start = time.time()
            n_samples = 0
            pending: list = []
            for it, batch in enumerate(train_loader):
                pending.append(prepare_batch(batch, device))
                if len(pending) < k_steps and it < len(train_loader) - 1:
                    continue
                pending += pending[-1:] * (k_steps - len(pending))  # pad the tail
                keys = augment_keys(rng_key, total_iter, k_steps) if augment else None
                gens = [step_generator(gen, seed, total_iter * k_steps + i) for i in range(k_steps)]
                losses, metrics, info = dispatch(step, pending, gens, keys)
                last_batch, pending = pending[-1], []
                n_samples += train_bs * k_steps * world
                if it % conf.train.log_every_iter < k_steps:
                    if shard:  # the global batch's losses
                        losses = dict(zip(losses, distributed.all_reduce_mean(list(losses.values()),
                                                                              group)))
                    losses_np = {k: float(v) for k, v in losses.items()}  # the host read
                    lr = schedule(total_iter * k_steps // accum)
                    sps = n_samples / (time.time() - t_start + 1e-9)
                    logger.info("[E %d | it %d] loss {%s} lr %.2e %.1f samples/s", epoch, it,
                                ", ".join(f"{k} {v:.3f}" for k, v in losses_np.items()), lr, sps)
                    if writer:
                        x = total_iter if conf.train.log_it else total_iter * train_bs
                        for k, v in losses_np.items():
                            writer.add_scalar(f"training/loss/{k}", v, x)
                        writer.add_scalar("training/lr", lr, x)
                        writer.add_scalar("training/grad_norm", float(info["grad_norm"]), x)
                        writer.add_scalar("training/samples_per_sec", sps, x)
                if (conf.train.log_grad_every_iter and writer
                        and total_iter % conf.train.log_grad_every_iter == 0):
                    writer.add_scalar("training/grad_global_norm", float(info["grad_norm"]), total_iter)

                if ((total_iter % conf.train.eval_every_iter == 0 and total_iter > 0)
                        or it == len(train_loader) - 1):
                    results, pr_results = do_evaluation(model, val_loader, conf.train, device, seed,
                                                        max_iters=args.max_val_iters,
                                                        augment=augment and (augment, eval_key(rng_key)),
                                                        group=group)
                    logger.info("[Validation] {%s}", ", ".join(
                        f"{k} {v:.4f}" for k, v in results.items() if np.isscalar(v)))
                    if writer:
                        for k, v in results.items():
                            if np.isscalar(v):
                                writer.add_scalar(f"val/{k}", float(v), total_iter)
                        for k, (labels, predictions) in pr_results.items():
                            if len(labels):
                                writer.add_pr_curve(f"val/{k}", labels, predictions, total_iter)
                    window = total_iter // max(conf.train.eval_every_iter, 1)
                    if plot and window % plot[0] == 0:  # plot is set only with a writer
                        plot_hook(model, last_batch, plot[1], writer, total_iter,
                                  generator_seed(seed, total_iter * k_steps + k_steps - 1),
                                  augment and (augment, keys[-1]))
                if stop or sig.stop:
                    stop = True
                    break
                total_iter += 1

            if not main_rank:
                continue
            for bench_name in conf.train.run_benchmarks or []:
                run_benchmark_hook(bench_name, conf, model, output_dir, args.device, writer,
                                   total_iter)

            state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                     "step": step.state_dict()}
            scalars = {k: v for k, v in results.items() if np.isscalar(v)}
            path = save_checkpoint(state, conf, scalars, output_dir, epoch, total_iter,
                                   interrupted=stop and sig.stop)
            best_eval = update_best_checkpoint(path, scalars, conf.train.best_key, best_eval)
            delete_old_checkpoints(output_dir, conf.train.keep_last_checkpoints)

    logger.info("Finished training.")
    if writer:
        writer.close()
    return model


def resolve_plot(plot_conf) -> tuple | None:
    """(every, figure function) of `train.plot` = [every, dotted path], or
    None where it is unset. A path that does not resolve, or that names the
    JAX package, raises ValueError."""
    if not plot_conf:
        return None
    every, path = plot_conf
    if str(path).split(".")[0] == "gluefactory_tpu":
        raise ValueError(f"train.plot: {path!r} is in the JAX package; the port's is "
                         "gluefactory_tpu_torch.visualization.visualize_batch.make_match_figures")
    fn = pydoc.locate(str(path))
    if fn is None:
        raise ValueError(f"train.plot: {path!r} does not resolve to a figure function")
    return int(every), fn


def plot_hook(model, batch: dict, fig_fn, writer, total_iter: int, seed: int, augment=None) -> dict:
    """`fig_fn(pred, batch)`'s figures to `writer` as `figures/<name>` at
    `total_iter`, pred the model's train-mode forward on `batch` under
    no_grad, drawing from a generator of its own seeded with `seed`.
    `augment`: (device_augment conf, key) for a batch of `source_image`s.
    Every buffer of the model (BatchNorm's running statistics) is put back
    and torch's global generators are forked, so training goes on as if the
    hook had not run. A failure is logged and training goes on. Returns
    {"pred", "figures" (names written), "error" (None, or what was logged)}."""
    device = next(model.parameters()).device
    buffers = [b.detach().clone() for b in model.buffers()]
    out = {"pred": None, "figures": [], "error": None}
    try:
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []), \
                torch.no_grad():
            if augment and "source_image" in batch:
                batch = apply_device_augment(batch, augment[1], augment[0])
            gen = torch.Generator(device=device).manual_seed(seed)
            out["pred"] = model(batch, train=True, generator=gen)
        for name, fig in fig_fn(out["pred"], batch).items():
            writer.add_figure(f"figures/{name}", fig, total_iter)
            out["figures"].append(name)
    except Exception as e:  # a figure must never stop training
        out["error"] = f"{type(e).__name__}: {e}"
        logger.warning("plot hook failed: %s", out["error"])
    finally:
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
    return out


def run_benchmark_hook(name: str, conf, model, output_dir: Path, device, writer, total_iter: int):
    """One benchmark on the model in memory, its scalars to the writer; a
    failure is logged with its traceback and training goes on."""
    from .eval import run_benchmark

    try:
        s, _, _ = run_benchmark(name, conf.train.benchmark_conf.get(name, {}),
                                output_dir / "benchmarks" / name, model=model, device=device)
    except Exception:
        logger.exception("benchmark %s failed", name)
        return
    logger.info("[Benchmark %s] %s", name, s)
    if writer:
        for k, v in s.items():
            if np.isscalar(v) and not isinstance(v, str):
                writer.add_scalar(f"benchmark/{name}/{k}", float(v), total_iter)


@contextlib.contextmanager
def _profiled(output_dir: Path):
    """torch.profiler over the run, its trace written to `profile.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(output_dir / "profile.json"))


def main_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("experiment", type=str)
    parser.add_argument("--conf", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument("--restore", action="store_true")
    parser.add_argument("--no_tensorboard", action="store_true")
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--max_val_iters", type=int, default=None)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--no_capture", action="store_true")
    parser.add_argument("dotlist", nargs="*")
    return parser.parse_intermixed_args(argv)


def main(argv=None):
    args = main_args(argv)
    conf = Config(default_conf)
    if args.conf:
        # a path, or the name of one of the package's configs
        conf = merge(conf, from_yaml(str(parse_config_path(args.conf))))
    if args.dotlist:
        conf = merge(conf, from_dotlist(args.dotlist))
    output_dir = Path(TRAINING_PATH, args.experiment)
    output_dir.mkdir(parents=True, exist_ok=True)
    group = distributed.setup(args.device)  # under torchrun: rank 0 alone captures the log
    capture = contextlib.nullcontext()
    if not args.no_capture and (group is None or group.is_main):
        from .utils.stdout_capturing import capture_outputs

        capture = capture_outputs(output_dir / "log.txt")
    profiler = _profiled(output_dir) if args.profile else contextlib.nullcontext()
    with capture, profiler, torch.autograd.set_detect_anomaly(args.detect_anomaly):
        return training(conf, output_dir, args)


if __name__ == "__main__":
    main()
