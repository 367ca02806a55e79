"""JAX's default PRNG in torch: keys, `split`, `fold_in` and the draws the
port needs, each bit for bit as `jax.random` gives them, on any device.

The RANSAC draws its minimal sets as a Gumbel top-k
(`ops/ransac.py::sample_minimal_sets`), so the same noise gives the port the
same hypotheses as the JAX package, and with them the same RANSAC result.
The on-device homography augmentation (`data/device_homography.py`) draws
its corner offsets, angle orders, translations and photometric jitter from
the key chain of the JAX trainer, so a step's batch equals JAX's.
What JAX 0.9 computes, with 64-bit types off and `jax_threefry_partitionable`
on (its default):
- the key of a seed is (0, seed mod 2^32) for a seed that fits in int32;
- the bits of element i (row-major) are threefry2x32(key, (hi(i), lo(i)))'s
  two words XORed, hi and lo the halves of i as a 64-bit count;
- `split(key, n)`: key i is both words of threefry2x32(key, (0, i));
  `fold_in(key, d)`: both words of threefry2x32(key, (0, d mod 2^32));
- uniform floats: the bits' top 23 under the exponent of 1.0, minus 1, then
  `max(minval, f * (maxval - minval) + minval)` in float32;
- normal: `sqrt(2) * erf_inv(u)`, u uniform on [nextafter(-1, 0), 1), with
  XLA's float32 `erf_inv` (Giles' polynomials in w = -log1p(-u^2), each
  multiply-add rounded once). The log1p is taken in float64 and rounded,
  where XLA has its own float32 log1p, so a draw may differ from JAX's by a
  few ulps of its value (3 at most in the tests' draws, which allow 4);
- `permutation(key, x)`: ceil(3 ln n / ln(2^32 - 1)) rounds (one for n
  below ~1600), each `key, sub = split(key)` and a stable sort of x by
  `bits(sub, x.shape)`;
- Gumbel noise -log(-log(u)) ("low" mode), u uniform on [tiny, 1): each log
  is taken in float64 and rounded to float32, within an ulp of XLA's
  float32 log at every step (torch's float32 log on the CPU is off by up to
  1e-4 in the noise where u is near 1, the largest values, which the top-k
  picks).

A key is a pair of uint32 words: `key(seed)` gives it as two ints; the
functions here also take a seed, or an int64 tensor (..., 2) of keys, whose
leading dims act as `jax.vmap` over keys would (a draw of `shape` from
keys (*K, 2) is (*K, *shape)). Key arithmetic runs on the key tensor's
device (the CPU for keys made from ints); the draws run on `device`. The
words are uint32 values held in int64 tensors and masked to 32 bits after
each addition and shift.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def key(seed: int) -> tuple[int, int]:
    """The two words of `jax.random.key(seed)`."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit in int32, as JAX without 64-bit types needs")
    return 0, seed & MASK


def as_key(k) -> torch.Tensor:
    """A seed, a pair of words or a key tensor -> int64 tensor (..., 2)."""
    if torch.is_tensor(k):
        if k.shape[-1:] != (2,):
            raise ValueError(f"a key tensor ends in a dim of 2, got {tuple(k.shape)}")
        return k.to(torch.int64)
    if isinstance(k, (int, np.integer)):
        k = key(int(k))
    return torch.tensor([int(k[0]) & MASK, int(k[1]) & MASK], dtype=torch.int64)


def _rotate_left(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under key
    k = (k0, k1): ints, or tensors that broadcast with the counters."""
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


def split(k, num: int = 2) -> torch.Tensor:
    """`jax.random.split(k, num)`: keys (..., num, 2)."""
    k = as_key(k)
    count = torch.arange(num, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32((k[..., 0, None], k[..., 1, None]), count >> 32, count & MASK)
    return torch.stack([b0, b1], dim=-1)


def fold_in(k, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)`: a key (..., 2)."""
    k = as_key(k)
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    b0, b1 = threefry2x32((k[..., 0], k[..., 1]), torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def bits(k, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32) as int64: (*keys, *shape)."""
    k = as_key(k)
    shape = tuple(shape)
    batch = k.shape[:-1]
    k = k.to(device).reshape(batch + (1,) * max(len(shape), 1) + (2,))
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device).reshape(shape or (1,))
    b0, b1 = threefry2x32((k[..., 0], k[..., 1]), count >> 32, count & MASK)
    return (b0 ^ b1).reshape(batch + shape)


def uniform(k, shape, device=None, minval=TINY, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`. The default
    `minval` is float32's tiny, the Gumbel draw's; JAX's own default is 0:
    pass `minval=0.0`. Bounds are floats or tensors that broadcast with
    the draw."""
    raw = (bits(k, shape, device) >> 9) | 0x3F800000
    floats = raw.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=floats.device)
    # (1 - tiny) rounds to 1 in float32, as in JAX; XLA fuses the
    # multiply-add, so it is rounded once: the float32 product is exact in
    # float64
    return torch.maximum(lo, (floats.double() * (hi - lo).double() + lo.double()).float())


# XLA's ErfInv32 coefficients, for w < 5 and for w >= 5
_ERFINV = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv of x in (-1, 1) (module docstring)."""
    w = -torch.log1p(-(x * x).double()).float()
    lt = w < 5
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(lt, np.float32(a), np.float32(b)).double() for a, b in zip(*_ERFINV)]
    p = coef[0]
    for c in coef[1:]:
        p = (p * w + c).float().double()  # a fused multiply-add in float32
    return p.float() * x


def normal(k, shape, device=None) -> torch.Tensor:
    """`jax.random.normal(k, shape, float32)`, within a few ulps (module
    docstring)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return np.float32(math.sqrt(2)) * erf_inv(uniform(k, shape, device, lo, 1.0))


def permutation(k, x) -> torch.Tensor:
    """`jax.random.permutation(k, x)` of a 1-D tensor x (or `arange(x)` for
    an int): (*keys, n)."""
    x = torch.arange(x) if isinstance(x, (int, np.integer)) else x
    k = as_key(k)
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = x.to(k.device).expand(k.shape[:-1] + (n,))
    for _ in range(rounds):
        keys = split(k)
        k, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x


def gumbel(seed, shape, device=None) -> torch.Tensor:
    """`jax.random.gumbel(jax.random.key(seed), shape, jnp.float32)`."""
    inner = -torch.log(uniform(seed, shape, device).double()).float()
    return -torch.log(inner.double()).float()
