"""Training engine on one CUDA device (counterpart of `gluefactory_tpu/train.py`).

    python -m gluefactory_tpu_torch.train <experiment> --conf <yaml> [dotlist]
        [--device cuda|cpu] [--overfit] [--restore] [--no_tensorboard]
        [--max_val_iters N] [--detect_anomaly] [--profile] [--no_capture]

A train step is the forward with the loss (ground truth on the device in the
pipeline's loss), the backward, and the optimizer update with the JAX
package's NaN-skip, all without a host read: a gradient tensor with any
non-finite entry is zeroed, the update applied, and the parameters and the
whole optimizer state (Adam's step count included) put back with
`torch.where` if the loss or any updated parameter is not finite. The host
reads the losses only where it logs (`log_every_iter`) and at evaluation.

Frozen components (`trainable: False`) have no gradient and are not in the
optimizer; `opt_regexp` keeps in the optimizer only the parameters whose
torch name matches it. `grad_accumulation` K averages K micro-batches
before one update; the lr schedule counts real updates, in the epoch
fraction `updates / (steps_per_epoch / K)`.

Where the port differs from the JAX trainer:
  - the lr schedule's count is the host's count of dispatched updates, so
    after a skipped (non-finite) update it runs one update ahead of optax's,
    whose count is restored with the rest of the state;
  - under `grad_accumulation`, a micro-batch with a non-finite loss adds
    nothing to the mean, and a skipped update drops its accumulated
    gradients (optax.MultiSteps retries the update on the next micro-batch);
  - `rmsprop` adds `eps` outside the square root (torch), optax inside.
Not ported yet, each raising `NotImplementedError`: `mixed_precision: bf16`,
`steps_per_dispatch > 1`, `device_augment`, `run_benchmarks`, `plot` with a
writer, and more than one device (DDP).
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
from .models import get_model
from .settings import TRAINING_PATH
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
    data epoch). Adam, AdamW and RMSprop keep their step count on a CUDA
    device (`capturable`), where the NaN-skip can restore it."""
    accum = int(conf.get("grad_accumulation") or 1)
    schedule = build_lr_schedule(conf, steps_per_epoch / accum)
    named = trained_parameters(conf, model)
    params = [p for _, p in named]
    if not params:
        raise ValueError("no parameter to train")
    opts = dict(conf.optimizer_options or {})
    if "b1" in opts or "b2" in opts:  # optax's names
        opts["betas"] = (opts.pop("b1", 0.9), opts.pop("b2", 0.999))
    capturable = params[0].device.type == "cuda"
    if conf.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=float(conf.lr), capturable=capturable, **opts)
    elif conf.optimizer == "adamw":
        opts.setdefault("weight_decay", 1e-4)  # optax's default
        opt = torch.optim.AdamW(params, lr=float(conf.lr), capturable=capturable, **opts)
    elif conf.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=float(conf.lr), **opts)
    elif conf.optimizer == "rmsprop":
        opts.setdefault("alpha", opts.pop("decay", 0.9))  # optax's name and default
        opt = torch.optim.RMSprop(params, lr=float(conf.lr), capturable=capturable, **opts)
    else:
        raise ValueError(f"unknown optimizer {conf.optimizer}")
    n_total = sum(1 for _ in model.parameters())
    logger.info("Optimizer: %d/%d parameter tensors trainable", len(params), n_total)
    return opt, schedule


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _all_finite(tensors) -> torch.Tensor:
    """0-dim bool: every entry of every tensor is finite (a NaN or inf makes
    the tensor's max-abs norm non-finite)."""
    return torch.isfinite(torch.stack(torch._foreach_norm(tensors, float("inf")))).all()


class TrainStep:
    """One call is one micro-batch: forward with loss (`train=True`),
    backward, and every `grad_accumulation`-th call one optimizer update
    with the NaN-skip. Returns (losses, metrics, info) as device tensors:
    the batch means, `grad_norm` (the global norm of the raw gradients) and
    `ok` (the update was applied)."""

    def __init__(self, model, optimizer, schedule, accum: int = 1, clip_grad=None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.accum = int(accum)
        self.clip_grad = clip_grad
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.trained = [p for g in optimizer.param_groups for p in g["params"]]
        self.updates = 0  # real updates dispatched: the schedule's step
        self.micro = 0  # micro-batches since the last update
        self.acc_sum = None
        self.acc_count = None

    def state_dict(self) -> dict:
        return {"updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        self.updates = int(state["updates"])

    def __call__(self, batch: dict, generator: torch.Generator | None = None):
        for p in self.params:
            p.grad = None
        _, losses, metrics = self.model.forward_with_loss(batch, train=True, generator=generator)
        loss = losses["total"].mean()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # a gradient tensor with any non-finite entry is zeroed
        safe = {p: torch.where(torch.isfinite(n), g, torch.zeros_like(g))
                for p, g, n in zip(self.params, grads, torch._foreach_norm(grads, float("inf")))}
        loss_ok = torch.isfinite(loss)
        if self.accum > 1:
            ok = self._accumulate([safe[p] for p in self.trained], loss_ok)
        else:
            ok = self._update([safe[p] for p in self.trained], loss_ok)
        losses = {k: v.detach().mean() for k, v in losses.items()}
        metrics = {k: v.detach().float().mean() for k, v in metrics.items()}
        return losses, metrics, {"grad_norm": grad_norm.detach(), "ok": ok}

    def _accumulate(self, grads, loss_ok):
        """Sum the micro-batch's gradients if its loss is finite; update with
        their mean at the K-th micro-batch."""
        if self.acc_sum is None:
            self.acc_sum = [torch.zeros_like(g) for g in grads]
            self.acc_count = torch.zeros((), device=grads[0].device)
        w = loss_ok.to(grads[0].dtype)
        torch._foreach_add_(self.acc_sum, torch._foreach_mul(grads, w))
        self.acc_count += w
        self.micro += 1
        if self.micro < self.accum:
            return loss_ok
        mean = torch._foreach_div(self.acc_sum, self.acc_count.clamp(min=1.0))
        ok = self._update(mean, self.acc_count > 0)
        self.micro = 0
        self.acc_sum = None
        return ok

    def _optimizer_tensors(self) -> list:
        """(param, key, tensor) of the optimizer's state tensors."""
        return [(p, k, v) for p in self.trained for k, v in self.optimizer.state.get(p, {}).items()
                if torch.is_tensor(v)]

    def _update(self, grads, loss_ok) -> torch.Tensor:
        """One optimizer update with `grads`, undone on the device unless the
        loss and every updated parameter are finite."""
        old_params = [p.detach().clone() for p in self.trained]
        old_state = {(id(p), k): v.clone() for p, k, v in self._optimizer_tensors()}
        if self.clip_grad is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_grad, 1.0, self.clip_grad / norm)
            grads = torch._foreach_mul(grads, scale)
        for p, g in zip(self.trained, grads):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.optimizer.step()
        self.updates += 1
        with torch.no_grad():
            ok = loss_ok & _all_finite(self.trained)
            for p, old in zip(self.trained, old_params):
                p.copy_(torch.where(ok, p, old))
            for p, k, v in self._optimizer_tensors():
                # state created by this (first) update goes back to zeros,
                # the value every optimizer here starts from
                old = old_state.get((id(p), k))
                v.copy_(torch.where(ok, v, torch.zeros_like(v) if old is None else old))
        return ok


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def do_evaluation(model, loader, conf, device, seed: int, max_iters=None):
    """Validation loop (`train=False`) with streaming accumulators: losses
    under `loss/`, metrics, medians and recalls as `conf` asks, and the PR
    curves' (labels, predictions). Every batch draws its random keypoint
    fill from a generator seeded with `seed`. Returns (results, pr_results)."""
    accums = {}
    pr_accums = defaultdict(PRMetric)
    gen = torch.Generator(device=device)
    with torch.no_grad():
        for i, batch in enumerate(loader):
            if max_iters is not None and i >= max_iters:
                break
            batch = prepare_batch(batch, device)
            pred, losses, metrics = model.forward_with_loss(batch, train=False,
                                                            generator=gen.manual_seed(seed))
            for name, spec in (conf.pr_curves or {}).items():
                pr_accums[name].update(pred[spec["labels"]], pred[spec["predictions"]],
                                       mask=pred[spec["mask"]] if "mask" in spec else None)
            numbers = {**{f"loss/{k}": v for k, v in losses.items()}, **metrics}
            for k, v in numbers.items():
                v = v.detach().float().cpu().numpy()
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


def step_generator(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
    """`generator` reseeded from (seed, step)."""
    return generator.manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1)[0]))


def check_supported(conf, args) -> None:
    """Raise on the options that are not ported yet."""
    t = conf.train
    if args.n_devices not in (None, 1):
        raise NotImplementedError("training on more than one device (DDP) is not ported yet")
    if t.mixed_precision:
        raise NotImplementedError(f"mixed_precision {t.mixed_precision!r} is not ported yet")
    if int(t.steps_per_dispatch) > 1:
        raise NotImplementedError("steps_per_dispatch > 1 is not ported yet")
    if t.device_augment:
        raise NotImplementedError("device_augment (on-device augmentation) is not ported yet")
    if t.run_benchmarks:
        raise NotImplementedError("run_benchmarks is not ported yet (the evals are not)")


def training(conf: Config, output_dir: Path, args):
    """Train `conf.model` on `conf.data` into `output_dir`; returns the model."""
    check_supported(conf, args)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to train on the CPU")
    seed = conf.train.seed
    gen = set_seed(seed, device)
    writer = None
    if not args.no_tensorboard:
        try:
            from tensorboardX import SummaryWriter

            writer = SummaryWriter(str(output_dir))
        except ImportError:
            pass
    if conf.train.plot and writer is not None:
        raise NotImplementedError("train.plot (figures to the writer) is not ported yet")

    # data
    dataset = get_dataset(conf.data.name)(conf.data)
    pin = device.type == "cuda"
    if args.overfit:
        train_loader = dataset.get_overfit_loader("train", pin_memory=pin)
        val_loader = dataset.get_overfit_loader("val", pin_memory=pin)
    else:
        train_loader = dataset.get_data_loader("train", pin_memory=pin)
        val_loader = dataset.get_data_loader("val", pin_memory=pin)
    steps_per_epoch = max(len(train_loader), 1)
    logger.info("Training loader has %d batches", steps_per_epoch)

    # model and optimizer
    model = get_model(conf.model.name).from_conf(
        {k: v for k, v in conf.model.to_dict().items() if k != "name"}, device=device)
    logger.info("Model has %.2fM parameters", sum(p.numel() for p in model.parameters()) / 1e6)
    optimizer, schedule = build_optimizer(conf.train, model, steps_per_epoch)
    clip = conf.train.clip_grad
    step = TrainStep(model, optimizer, schedule, conf.train.grad_accumulation,
                     None if clip is None else float(clip))

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
        model.load_state_dict(payload["model"])
        logger.info("Warm-started from experiment %s", conf.train.load_experiment)
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
                train_loader = dataset.get_data_loader("train", pin_memory=pin)
            dataset.epoch = epoch
            t_start = time.time()
            n_samples = 0
            for it, batch in enumerate(train_loader):
                batch = prepare_batch(batch, device)
                losses, metrics, info = step(batch, step_generator(gen, seed, total_iter))
                n_samples += train_bs
                if it % conf.train.log_every_iter == 0:
                    losses_np = {k: float(v) for k, v in losses.items()}  # the host read
                    lr = schedule(total_iter // step.accum)
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
                                                        max_iters=args.max_val_iters)
                    logger.info("[Validation] {%s}", ", ".join(
                        f"{k} {v:.4f}" for k, v in results.items() if np.isscalar(v)))
                    if writer:
                        for k, v in results.items():
                            if np.isscalar(v):
                                writer.add_scalar(f"val/{k}", float(v), total_iter)
                        for k, (labels, predictions) in pr_results.items():
                            if len(labels):
                                writer.add_pr_curve(f"val/{k}", labels, predictions, total_iter)
                if stop or sig.stop:
                    stop = True
                    break
                total_iter += 1

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
        conf = merge(conf, from_yaml(args.conf))
    if args.dotlist:
        conf = merge(conf, from_dotlist(args.dotlist))
    output_dir = Path(TRAINING_PATH, args.experiment)
    output_dir.mkdir(parents=True, exist_ok=True)
    capture = contextlib.nullcontext()
    if not args.no_capture:
        from .utils.stdout_capturing import capture_outputs

        capture = capture_outputs(output_dir / "log.txt")
    profiler = _profiled(output_dir) if args.profile else contextlib.nullcontext()
    with capture, profiler, torch.autograd.set_detect_anomaly(args.detect_anomaly):
        return training(conf, output_dir, args)


if __name__ == "__main__":
    main()
