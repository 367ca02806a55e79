"""Seeded random variables for a flax model of the JAX package, drawn with
numpy from the shapes `jax.eval_shape` gives its `init`: nothing is
compiled, so a test pays only for the `apply` it compares against.

Kernels are normal with std 1/sqrt(fan in) (a deformable conv's offset
predictor included, whose flax init is zeros, so the taps move), biases
normal with std 0.1, BatchNorm scales 1 + 0.1 x normal, PReLU gates 0.25 +
0.05 x normal, ALIKED's `agg_weights` normal with std 1/sqrt(M x C); the
running means normal with std 0.1 and the running variances uniform in
[0.5, 1.5], so that normalising by them differs from normalising by the
batch.
"""

from __future__ import annotations

import jax
import numpy as np


def _draw(rng, path, shape):
    names = [getattr(p, "key", str(p)) for p in path]
    name, collection = names[-1], names[0]
    if collection == "batch_stats":
        if name == "mean":
            return 0.1 * rng.standard_normal(shape)
        return rng.uniform(0.5, 1.5, shape)
    if name == "kernel":
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name == "agg_weights":
        return rng.standard_normal(shape) / np.sqrt(shape[0] * shape[1])
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "gate":
        return 0.25 + 0.05 * rng.standard_normal(shape)
    if len(shape) == 0:
        return rng.standard_normal(shape)
    return 0.1 * rng.standard_normal(shape)


def random_variables(model, *args, seed: int = 0, method=None) -> dict:
    """{"params": ..., "batch_stats": ...} (numpy float32) for `model.init`
    on `args` (`method` as `init` takes it)."""
    key = jax.random.key(0)
    kw = {} if method is None else {"method": method}
    shapes = jax.eval_shape(lambda: model.init({"params": key, "sample": key}, *args, **kw))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_draw(rng, path, s.shape), np.float32), dict(shapes))
