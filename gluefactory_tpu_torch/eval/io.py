"""Eval configs, CLI and model loading (counterpart of
`gluefactory_tpu/eval/io.py`).

Named configs resolve from `gluefactory_tpu_torch/configs/*.yaml`; a
benchmark's section comes from `benchmarks.<name>`; the merge order is the
pipeline's defaults < the config < a checkpoint's model < the CLI dotlist.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from pprint import pprint

import numpy as np
import torch

from .. import logger
from ..core.config import Config, from_dotlist, from_yaml, merge
from ..data.base_dataset import prepare_batch
from ..models import get_model
from ..settings import TRAINING_PATH


def parse_config_path(name_or_path: str, defaults: str = "configs/") -> Path:
    default_dir = Path(__file__).parent.parent / defaults
    default_configs = {p.stem: p for p in default_dir.glob("**/*.yaml")}
    if name_or_path in default_configs:
        return default_configs[name_or_path]
    path = Path(name_or_path)
    if not path.exists():
        raise ValueError(f"Cannot find the config file: {name_or_path}. "
                         f"Not in the default configs {list(default_configs)}")
    return path


def extract_benchmark_conf(conf: Config, benchmark: str) -> Config:
    """The model conf merged with the `benchmarks.<name>` section."""
    mconf = Config({"model": conf.get("model", {})})
    if "benchmarks" in conf:
        return merge(mconf, conf.benchmarks.get(benchmark, {}))
    return mconf


def parse_eval_args(benchmark: str, args, configs_path: str, default=None):
    """The eval CLI's arguments as (name, conf)."""
    conf = Config({"data": {}, "model": {}, "eval": {}})
    if args.conf:
        conf_path = parse_config_path(args.conf, configs_path)
        conf = merge(conf, extract_benchmark_conf(from_yaml(str(conf_path)), benchmark))
        args.tag = args.tag if args.tag is not None else conf_path.stem
    cli_conf = from_dotlist(args.dotlist) if args.dotlist else Config({})
    conf = merge(conf, cli_conf)
    conf = conf.set("checkpoint", args.checkpoint or conf.get("checkpoint"))
    if conf.get("checkpoint"):
        ckpt_conf = Path(TRAINING_PATH, conf.checkpoint) / "config.yaml"
        if ckpt_conf.exists():
            conf = merge(Config({"model": from_yaml(str(ckpt_conf)).get("model", {})}), conf)
    if default is not None:
        conf = merge(Config(default), conf)
    name = args.tag or args.checkpoint or "default"
    if len(args.dotlist) > 0 and not args.tag:
        name = name + "_" + ":".join(args.dotlist)
    logger.info("Running benchmark: %s", benchmark)
    logger.info("Experiment tag: %s", name)
    logger.info("Config:")
    pprint(conf.to_dict())
    return name, conf


def get_eval_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tag", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--conf", type=str, default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--overwrite_eval", action="store_true")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("dotlist", nargs="*")
    return parser


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu to run on the CPU")


def load_model(model_conf, checkpoint, device="cuda"):
    """The model, in eval mode on `device`: a training run's (`checkpoint`
    names it, `utils/experiments.load_experiment`), else built from the conf
    with random weights from torch's generator, then the conf's
    `weights_file` and each component's `<component>.weights_file` loaded
    into it as `torch.save` state dicts."""
    if checkpoint:
        from ..utils.experiments import load_experiment

        conf = {"model": model_conf.to_dict() if isinstance(model_conf, Config) else model_conf}
        model, _ = load_experiment(checkpoint, conf=conf, device=device)
        return model.eval()
    model_conf = Config(model_conf)
    model = get_model(model_conf.get("name")).from_conf(
        {k: v for k, v in model_conf.to_dict().items() if k != "name"}, device=device)
    targets = [(model_conf, model)] + [
        (model_conf.get(c), getattr(model, c)) for c in getattr(model, "components", ())
        if isinstance(model_conf.get(c), Config) and getattr(model, c, None) is not None]
    for conf, module in targets:
        weights = conf.get("weights_file")
        if not weights:
            continue
        if str(weights).endswith(".msgpack"):
            raise ValueError(f"{weights}: a flax msgpack of the JAX package; convert it to a "
                             "torch state dict (compat/jax_params.from_jax_params) first")
        logger.info("Loading weights from %s", weights)
        module.load_state_dict(torch.load(weights, map_location=device, weights_only=True))
    return model.eval()


def _strip_non_tensors(batch):
    """The batch without its strings (names, scenes)."""
    if isinstance(batch, dict):
        return {k: _strip_non_tensors(v) for k, v in batch.items()
                if not (isinstance(v, (str, bytes)) or (isinstance(v, list) and v
                                                        and isinstance(v[0], str)))}
    return batch


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def make_apply_fn(model, device="cuda"):
    """`apply(batch) -> pred`: the batch (numpy or tensors) on `device`, the
    forward under no_grad, the predictions back as numpy. The keypoint fill
    of SuperPoint, where it samples, draws from a generator seeded with 0 at
    each call."""
    generator = torch.Generator(device=device)

    def apply_fn(batch):
        batch = prepare_batch(_strip_non_tensors(batch), device)
        with torch.no_grad():
            pred = model(batch, generator=generator.manual_seed(0))
        return {k: _to_numpy(v) for k, v in pred.items() if torch.is_tensor(v)}

    return apply_fn
