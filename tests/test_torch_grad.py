"""Gradients through the port's kernel wrappers.

On the card each wrapper runs its kernel forward and, under autograd, the
plain version's gradient (`ops/_autograd.py`), as the JAX package's custom
VJPs recompute a jnp reference. Here, on the CPU: the plain versions'
gradients against `jax.vjp` / `jax.grad` of the JAX functions on the same
numpy-seeded inputs, the helper `autograd.Function` with the plain version
in the kernel's place against plain autograd, and the decode's guard (the
JAX kernel has no gradient either).

Tolerances: f32 throughout; the same products and sums in another order,
held to 1e-4 of the largest gradient entry (relative 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops.assignment import log_sinkhorn_iterations as jax_log_sinkhorn
from gluefactory_tpu.ops.pallas_attention import _bidir_reference, _mha_reference
from gluefactory_tpu.ops.pallas_conv import _vgg_ad
from gluefactory_tpu.ops.pallas_detect import fused_nms_tile_reduce as jax_nms_tile_reduce
from gluefactory_tpu_torch.ops import _autograd, cuda_attention, cuda_conv, cuda_detect, cuda_sinkhorn

RTOL = 1e-4


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _t(*arrays):
    return [torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in arrays]


def _attention_inputs(rng, B=2, H=2, M=24, N=20, D=32):
    q = rng.normal(size=(B, H, M, D)).astype(np.float32)
    k = rng.normal(size=(B, H, N, D)).astype(np.float32)
    v = rng.normal(size=(B, H, N, D)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.3
    mask[1] = False  # a batch with no valid key: zeros, no gradient through softmax
    return q, k, v, mask


def test_attention_plain_grad_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v, mask = _attention_inputs(rng)
    g = rng.normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: _mha_reference(a, b, c, jnp.asarray(mask)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = _t(q, k, v)
    out = cuda_attention.attention_plain(qt, kt, vt, torch.from_numpy(mask))
    got = torch.autograd.grad(out, [qt, kt, vt], torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b)


def test_bidirectional_plain_grad_matches_jax():
    rng = np.random.default_rng(1)
    B, H, M, N, D = 2, 2, 24, 20, 32
    qk0, v0 = (rng.normal(size=(B, H, M, D)).astype(np.float32) for _ in range(2))
    qk1, v1 = (rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(2))
    m0 = rng.uniform(size=(B, M)) > 0.3
    m1 = rng.uniform(size=(B, N)) > 0.3
    g0 = rng.normal(size=(B, H, M, D)).astype(np.float32)
    g1 = rng.normal(size=(B, H, N, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c, d: _bidir_reference(a, b, c, d, jnp.asarray(m0), jnp.asarray(m1)),
                     *(jnp.asarray(x) for x in (qk0, qk1, v0, v1)))
    want = vjp((jnp.asarray(g0), jnp.asarray(g1)))
    ts = _t(qk0, qk1, v0, v1)
    o0, o1 = cuda_attention.bidirectional_plain(*ts, torch.from_numpy(m0), torch.from_numpy(m1))
    got = torch.autograd.grad([o0, o1], ts, [torch.from_numpy(g0), torch.from_numpy(g1)])
    for a, b in zip(got, want):
        _close(a, b)


def _vgg_inputs(rng, two, shape=(2, 12, 10), ci=8, cm=16, co=16):
    mk = lambda *s: rng.normal(0, 0.5, s).astype(np.float32)  # noqa: E731
    x = mk(*shape, ci)
    w = [mk(3, 3, ci, cm), mk(cm)]
    w += [mk(3, 3, cm, co), mk(co)] if two else [np.zeros((1, 1, 1, 1), np.float32),
                                                  np.zeros((1,), np.float32)]
    return x, w


@pytest.mark.parametrize("variant", ["one_conv_pool", "two_convs_pool", "two_convs_no_pool"])
def test_vgg_block_plain_grad_matches_jax(variant):
    """Against `jax.grad` through the JAX package's differentiable fused
    block (`_vgg_ad`: the Pallas kernel in interpret mode forward,
    `vgg_block_xla` recomputed backward)."""
    two, pool = variant != "one_conv_pool", variant != "two_convs_no_pool"
    rng = np.random.default_rng(2)
    x, w = _vgg_inputs(rng, two)
    out_shape = cuda_conv.vgg_block_plain(torch.from_numpy(x), *(torch.from_numpy(a) for a in w[:4 if two else 2]),
                                          pool=pool).shape
    g = rng.normal(size=tuple(out_shape)).astype(np.float32)

    def loss(*args):
        return jnp.sum(_vgg_ad(two, pool, True, *args) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *(jnp.asarray(a) for a in w))
    ts = _t(x, *w[:4 if two else 2])
    out = cuda_conv.vgg_block_plain(*ts, pool=pool)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b)


def test_log_sinkhorn_plain_grad_matches_jax():
    """The plain loop's gradient is `jax.grad` through
    `log_sinkhorn_iterations`' fori_loop, the route JAX trains on."""
    rng = np.random.default_rng(3)
    B, M, N, iters = 2, 9, 11, 10
    Z = rng.normal(size=(B, M, N)).astype(np.float32)
    mu = np.log(rng.uniform(0.5, 1.5, size=(B, M)) / (M + N)).astype(np.float32)
    nu = np.log(rng.uniform(0.5, 1.5, size=(B, N)) / (M + N)).astype(np.float32)
    g = rng.normal(size=(B, M, N)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_log_sinkhorn(*a, iters) * jnp.asarray(g)), argnums=(0, 1, 2))(
        jnp.asarray(Z), jnp.asarray(mu), jnp.asarray(nu))
    ts = _t(Z, mu, nu)
    out = cuda_sinkhorn.plain_log_sinkhorn(*ts, iters)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b)


def _helper_cases(rng):
    """(plain callable, its arguments) for each of the four kernels, with
    every kind of argument the wrappers pass: masks (bool, None), flags,
    counts."""
    q, k, v, mask = _attention_inputs(rng)
    x2, w2 = _vgg_inputs(rng, True)
    x1, w1 = _vgg_inputs(rng, False)
    Z = rng.normal(size=(2, 7, 5)).astype(np.float32)
    return {
        "fused_attention": (cuda_attention.attention_plain, [*_t(q, k, v), torch.from_numpy(mask), None]),
        "fused_bidirectional_attention": (cuda_attention.bidirectional_plain,
                                          [*_t(q, q[:, :, :20].copy(), q.copy(), v), None,
                                           torch.from_numpy(mask)]),
        "fused_vgg_block": (cuda_conv.vgg_block_plain, [*_t(x2, *w2), True]),
        "fused_vgg_block_one_conv": (cuda_conv.vgg_block_plain, [*_t(x1, *w1[:2]), None, None, True]),
        "log_sinkhorn": (cuda_sinkhorn.plain_log_sinkhorn,
                         [*_t(Z, np.full((2, 7), -2.5, np.float32), np.full((2, 5), -2.5, np.float32)), 6]),
    }


@pytest.mark.parametrize("name", ["fused_attention", "fused_bidirectional_attention", "fused_vgg_block",
                                  "fused_vgg_block_one_conv", "log_sinkhorn"])
def test_kernel_function_gives_the_plain_gradient(name):
    """The helper with the plain callable in the kernel's place: the output
    carries a grad_fn and the gradients equal plain autograd's (the same
    arithmetic, so equal to rounding); tensors that need no gradient get
    none."""
    plain, args = _helper_cases(np.random.default_rng(4))[name]
    out = _autograd.kernel_with_plain_grad(plain, plain, *args)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is not None for o in outs)
    ref = plain(*args)
    refs = ref if isinstance(ref, tuple) else (ref,)
    cot = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i)) for i, o in enumerate(outs)]
    leaves = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    got = torch.autograd.grad(outs, leaves, cot)
    want = torch.autograd.grad(refs, leaves, cot)
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_kernel_function_partial_needs():
    """Only the inputs that require a gradient get one; a cotangent for one
    output of two suffices."""
    rng = np.random.default_rng(5)
    q, k, v, _ = _attention_inputs(rng, M=20)
    qk0, qk1 = torch.from_numpy(q), torch.from_numpy(k).requires_grad_(True)
    v0, v1 = torch.from_numpy(q.copy()), torch.from_numpy(v)
    o0, o1 = _autograd.kernel_with_plain_grad(cuda_attention.bidirectional_plain,
                                              cuda_attention.bidirectional_plain,
                                              qk0, qk1, v0, v1, None, None)
    (g,) = torch.autograd.grad(o0.sum(), [qk1])
    (want,) = torch.autograd.grad(cuda_attention.bidirectional_plain(qk0, qk1, v0, v1)[0].sum(), [qk1])
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)


def test_needs_grad():
    a = torch.zeros(2, requires_grad=True)
    assert _autograd.needs_grad(a, None, 3)
    assert not _autograd.needs_grad(a.detach(), None)
    with torch.no_grad():
        assert not _autograd.needs_grad(a)


def test_detect_has_no_gradient_like_jax():
    """`jax.grad` through the JAX decode kernel raises, so the port's decode
    raises a clear RuntimeError under autograd on scores that require a
    gradient, and runs under no_grad or on detached scores."""
    rng = np.random.default_rng(6)
    s = rng.uniform(0.01, 1.0, size=(1, 64, 64)).astype(np.float32)
    with pytest.raises(Exception):
        jax.grad(lambda x: jnp.sum(jax_nms_tile_reduce(x, radius=3, interpret=True)[0]))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        cuda_detect.fused_nms_tile_reduce(st, radius=3)
    with torch.no_grad():
        tmax, targ = cuda_detect.fused_nms_tile_reduce(st, radius=3)
    want = cuda_detect.nms_tile_reduce_plain(st.detach(), radius=3)
    assert torch.equal(tmax, want[0]) and torch.equal(targ, want[1])
    assert torch.equal(cuda_detect.fused_nms_tile_reduce(st.detach(), radius=3)[0], want[0])
