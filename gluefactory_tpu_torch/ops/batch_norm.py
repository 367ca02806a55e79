"""BatchNorm as flax computes it, on channels-first maps.

The JAX package's extractors use `flax.linen.BatchNorm`: by the batch, it
normalises with the mean and the biased variance over every axis but the
channels, both in float32 (E[x^2] - E[x]^2, at least 0), and sets each
running statistic to `momentum` x old + (1 - momentum) x batch, the biased
variance included (PyTorch's own training mode would store the unbiased
one). Its `momentum` is the weight of the old value (0.9 or 0.99), the
complement of PyTorch's. Under data-parallel training the batch's
statistics are the global batch's (`utils/distributed.batch_mean`), as XLA
computes them over a sharded batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.distributed import batch_mean


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, by_batch: bool, momentum: float) -> torch.Tensor:
    """`bn`'s parameters (if affine) on x (B, C, H, W). `by_batch` False: by the running
    statistics. True: by the batch's statistics, after which the running
    ones move by flax's `momentum` (under no_grad, at once)."""
    if not by_batch:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps)
    xf = x.float()
    mean = batch_mean(xf.mean(dim=(0, 2, 3)))
    var = (batch_mean((xf * xf).mean(dim=(0, 2, 3))) - mean * mean).clamp(min=0.0)
    scale = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:  # an affine BatchNorm
        scale = scale * bn.weight.float()
    y = (xf - mean[:, None, None]) * scale[:, None, None]
    if bn.bias is not None:
        y = y + bn.bias.float()[:, None, None]
    with torch.no_grad():
        bn.running_mean.copy_(momentum * bn.running_mean + (1.0 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var + (1.0 - momentum) * var)
    return y.to(x.dtype)
