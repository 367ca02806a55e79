"""JAX's default PRNG in torch: enough of it to draw
`jax.random.gumbel(jax.random.key(seed), shape, jnp.float32)` bit for bit,
on any device.

The RANSAC draws its minimal sets as a Gumbel top-k
(`ops/ransac.py::sample_minimal_sets`), so the same noise gives the port the
same hypotheses as the JAX package, and with them the same RANSAC result.
What JAX 0.9 computes, with 64-bit types off and `jax_threefry_partitionable`
on (its default):
- the key of a seed is (0, seed mod 2^32) for a seed that fits in int32;
- the bits of element i (row-major) are threefry2x32(key, (hi(i), lo(i)))'s
  two words XORed, hi and lo the halves of i as a 64-bit count;
- uniform floats on [tiny, 1): the bits' top 23 under the exponent of 1.0,
  minus 1, then `max(tiny, f * (1 - tiny) + tiny)` in float32;
- Gumbel noise -log(-log(u)) ("low" mode): each log is taken in float64
  and rounded to float32, within an ulp of XLA's float32 log at every step
  (torch's float32 log on the CPU is off by up to 1e-4 in the noise where u
  is near 1, the largest values, which the top-k picks).
The words are uint32 values held in int64 tensors and masked to 32 bits
after each addition and shift.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def key(seed: int) -> tuple[int, int]:
    """The two words of `jax.random.key(seed)`."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32, as JAX without 64-bit types needs")
    return 0, seed & MASK


def _rotate_left(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under key k."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = x0 ^ _rotate_left(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def random_bits(seed: int, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(jax.random.key(seed), shape)` (uint32) as int64."""
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key(seed), count >> 32, count & MASK)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(seed: int, shape, device=None) -> torch.Tensor:
    """`jax.random.uniform(key(seed), shape, float32, minval=tiny)`."""
    tiny = torch.tensor(np.finfo(np.float32).tiny, device=device)
    bits = (random_bits(seed, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    scale = torch.tensor(1.0, device=device) - tiny  # rounds to 1 in float32, as in JAX
    return torch.maximum(tiny, floats * scale + tiny)


def gumbel(seed: int, shape, device=None) -> torch.Tensor:
    """`jax.random.gumbel(jax.random.key(seed), shape, jnp.float32)`."""
    inner = -torch.log(uniform(seed, shape, device).double()).float()
    return -torch.log(inner.double()).float()
