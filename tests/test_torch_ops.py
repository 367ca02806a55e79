"""The port's ops against the JAX package's on the same seeded inputs:
attention (plain versions against the jnp reference and against the Pallas
kernels in interpret mode), rotary, the assignment head, match filtering,
NMS and top-k in both branches, and descriptor sampling."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops import assignment as jax_assignment
from gluefactory_tpu.ops import attention as jax_attention
from gluefactory_tpu.ops import grid_sample as jax_grid_sample
from gluefactory_tpu.ops import nms as jax_nms
from gluefactory_tpu.ops.pallas_attention import fused_attention, fused_bidirectional_attention
from gluefactory_tpu_torch.ops import assignment, attention, grid_sample, nms
from gluefactory_tpu_torch.ops.cuda_attention import attention_plain, bidirectional_plain

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the tolerance of the JAX package's own kernel tests. bf16: outputs are
# rounded to bf16 (relative step 2^-8) after sums taken in another order, and
# the Pallas kernel rounds probabilities to bf16 before PV.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    t = torch.from_numpy(np.asarray(x, np.float32)).to(td)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mask_cases(rng, B, M, N):
    """all valid, random partial, side 0 fully masked, side 1 fully masked."""
    part0, part1 = rng.uniform(size=(B, M)) > 0.3, rng.uniform(size=(B, N)) > 0.3
    return {
        "all_valid": (np.ones((B, M), bool), np.ones((B, N), bool)),
        "partial": (part0, part1),
        "side0_masked": (np.zeros((B, M), bool), part1),
        "side1_masked": (part0, np.zeros((B, N), bool)),
    }


MASK_CASES = ["all_valid", "partial", "side0_masked", "side1_masked"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MASK_CASES)
def test_attention_plain_matches_jax(dtype, case):
    rng = np.random.default_rng(0)
    B, H, M, N, D = 2, 2, 40, 56, 32
    q, k, v = (_pair(rng.normal(size=(B, H, n, D)), dtype) for n in (M, N, N))
    mq, mk = _mask_cases(rng, B, M, N)[case]
    mq_j, mq_t = jnp.asarray(mq), torch.from_numpy(mq)
    mk_j, mk_t = jnp.asarray(mk), torch.from_numpy(mk)

    ref = jax_attention.mha(q[0], k[0], v[0], mask_q=mq_j, mask_k=mk_j, flash=False)
    out = attention.mha(q[1], k[1], v[1], mask_q=mq_t, mask_k=mk_t)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, M, D)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype])

    # the Pallas kernel itself (key mask only; query rows are zeroed outside it)
    kern = fused_attention(q[0], k[0], v[0], mk_j, block_q=16, interpret=True)
    np.testing.assert_allclose(_np(attention_plain(q[1], k[1], v[1], mk_t)), _np(kern),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MASK_CASES)
def test_bidirectional_plain_matches_jax(dtype, case):
    rng = np.random.default_rng(1)
    B, H, M, N, D = 2, 2, 48, 40, 32
    qk0, v0 = (_pair(rng.normal(size=(B, H, M, D)), dtype) for _ in range(2))
    qk1, v1 = (_pair(rng.normal(size=(B, H, N, D)), dtype) for _ in range(2))
    m0, m1 = _mask_cases(rng, B, M, N)[case]
    m0_j, m0_t = jnp.asarray(m0), torch.from_numpy(m0)
    m1_j, m1_t = jnp.asarray(m1), torch.from_numpy(m1)

    r0, r1 = jax_attention.bidirectional_attention(qk0[0], qk1[0], v0[0], v1[0], m0_j, m1_j,
                                                   flash=False)
    o0, o1 = attention.bidirectional_attention(qk0[1], qk1[1], v0[1], v1[1], m0_t, m1_t)
    assert o0.dtype == o1.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(o0), _np(r0), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(o1), _np(r1), atol=ATOL[dtype])

    k0, k1 = fused_bidirectional_attention(qk0[0], qk1[0], v0[0], v1[0], m0_j, m1_j,
                                           block_q=16, interpret=True)
    p0, p1 = bidirectional_plain(qk0[1], qk1[1], v0[1], v1[1], m0_t, m1_t)
    np.testing.assert_allclose(_np(p0), _np(k0), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(p1), _np(k1), atol=ATOL[dtype])


def test_attention_padded_keys_are_inert():
    """Keys beyond the mask, whatever their values, change nothing."""
    rng = np.random.default_rng(2)
    B, H, M, N, P, D = 1, 2, 24, 20, 12, 32
    q = torch.from_numpy(rng.normal(size=(B, H, M, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, H, N, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, H, N, D)).astype(np.float32))
    pad = torch.from_numpy(1e3 * rng.normal(size=(B, H, P, D)).astype(np.float32))
    mask = torch.cat([torch.ones(B, N, dtype=torch.bool), torch.zeros(B, P, dtype=torch.bool)], 1)
    ref = attention.mha(q, k, v)
    out = attention.mha(q, torch.cat([k, pad], 2), torch.cat([v, pad], 2), mask_k=mask)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-5)

    qk1 = torch.cat([k, pad], 2)
    v1 = torch.cat([v, pad], 2)
    m0, m1 = attention.bidirectional_attention(q, k, q, v)
    p0, p1 = attention.bidirectional_attention(q, qk1, q, v1, None, mask)
    torch.testing.assert_close(p0, m0, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(p1[:, :, :N], m1, atol=1e-6, rtol=1e-5)
    assert (p1[:, :, N:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rotary_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = _pair(rng.normal(size=(2, 3, 16, 32)), dtype)
    theta = rng.uniform(-3, 3, size=(2, 1, 16, 16))
    cos = _pair(np.cos(theta), "float32")
    sin = _pair(np.sin(theta), "float32")
    ref = jax_attention.apply_rotary(x[0], cos[0], sin[0])
    out = attention.apply_rotary(x[1], cos[1], sin[1])
    # f32 cos/sin must not upcast a bf16 trunk
    assert out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype] / 2)
    np.testing.assert_array_equal(_np(attention.rotate_half(x[1])),
                                  _np(jax_attention.rotate_half(x[0])))


def _assignment_inputs(rng, B=2, M=24, N=30):
    sim = rng.normal(size=(B, M, N)).astype(np.float32) * 3
    z0 = rng.normal(size=(B, M)).astype(np.float32)
    z1 = rng.normal(size=(B, N)).astype(np.float32)
    m0 = rng.uniform(size=(B, M)) > 0.2
    m1 = rng.uniform(size=(B, N)) > 0.2
    return sim, z0, z1, m0, m1


@pytest.mark.parametrize("masked", [False, True])
def test_sigmoid_log_double_softmax_and_filter_matches(masked):
    rng = np.random.default_rng(4)
    sim, z0, z1, m0, m1 = _assignment_inputs(rng)
    # plant strong mutual pairs so the filter has matches to keep
    for b in range(2):
        for i, j in [(1, 2), (5, 7), (10, 3), (20, 25)]:
            sim[b, i, j] = 12.0
    if not masked:
        m0 = m1 = None
    jm0 = None if m0 is None else jnp.asarray(m0)
    jm1 = None if m1 is None else jnp.asarray(m1)
    tm0 = None if m0 is None else torch.from_numpy(m0)
    tm1 = None if m1 is None else torch.from_numpy(m1)
    ref = jax_assignment.sigmoid_log_double_softmax(
        jnp.asarray(sim), jnp.asarray(z0), jnp.asarray(z1), jm0, jm1)
    out = assignment.sigmoid_log_double_softmax(
        torch.from_numpy(sim), torch.from_numpy(z0), torch.from_numpy(z1), tm0, tm1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)

    for th in (0.0, 0.1):
        rj = jax_assignment.filter_matches(ref, th, jm0, jm1)
        rt = assignment.filter_matches(out, th, tm0, tm1)
        assert rt[0].dtype == rt[1].dtype == torch.int32
        np.testing.assert_array_equal(rt[0].numpy(), np.asarray(rj[0]))
        np.testing.assert_array_equal(rt[1].numpy(), np.asarray(rj[1]))
        np.testing.assert_allclose(rt[2].numpy(), np.asarray(rj[2]), atol=1e-6)
        np.testing.assert_allclose(rt[3].numpy(), np.asarray(rj[3]), atol=1e-6)
        assert (rt[0] >= 0).sum() > 0
        if masked:
            assert (rt[0].numpy()[~m0] == -1).all() and (rt[1].numpy()[~m1] == -1).all()


def _score_map(rng, B=2, H=48, W=64):
    """Softmax-like scores with plateaus of exactly equal values (ties)."""
    s = rng.uniform(0, 1, size=(B, H, W)).astype(np.float32) ** 4
    s[:, 10:13, 20:23] = 0.5
    s[:, 30, 40:42] = 0.75
    return s


@pytest.mark.parametrize("radius", [2, 4])
def test_simple_nms_matches_jax(radius):
    s = _score_map(np.random.default_rng(5))
    ref = jax_nms.remove_borders(jax_nms.simple_nms(jnp.asarray(s), radius), 4)
    out = nms.remove_borders(nms.simple_nms(torch.from_numpy(s), radius), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(nms.max_pool_2d(torch.from_numpy(s), radius).numpy(),
                                  np.asarray(jax_nms.max_pool_2d(jnp.asarray(s), radius)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nms_radius", [None, 3, 4])
def test_top_k_keypoints_matches_jax(dtype, nms_radius):
    """Both tile branches (f32 tile max; bf16 packed keys with the "higher
    local index wins" tie rule) and the flat one, threshold included."""
    s = _score_map(np.random.default_rng(6))
    sj, st = _pair(s, dtype)
    sj = jax_nms.simple_nms(sj, 4)
    st = nms.simple_nms(st, 4)
    np.testing.assert_array_equal(_np(st), _np(sj))
    k = 40
    kj, vj, okj = jax_nms.top_k_keypoints(sj, k, 0.05, nms_radius=nms_radius)
    kt, vt, okt = nms.top_k_keypoints(st, k, 0.05, nms_radius=nms_radius)
    assert vt.dtype == DTYPES[dtype][1] and kt.dtype == torch.float32
    np.testing.assert_array_equal(_np(vt), _np(vj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    valid = np.asarray(okj)
    np.testing.assert_array_equal(kt.numpy()[valid], np.asarray(kj)[valid])


def test_top_k_bf16_tie_rule():
    """Inside a tile the packed-key branch keeps the highest local index of
    equal scores, as the JAX package does."""
    s = np.zeros((1, 8, 8), np.float32)
    s[0, 0, 0] = s[0, 1, 1] = 0.5  # same 4x4 tile, local index 0 and 5
    for dtype in ("float32", "bfloat16"):
        sj, st = _pair(s, dtype)
        kj, _, _ = jax_nms.top_k_keypoints(sj, 1, 0.0, nms_radius=4)
        kt, _, _ = nms.top_k_keypoints(st, 1, 0.0, nms_radius=4)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(kt.numpy(), [[[1.5, 1.5]]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("legacy", [True, False])
def test_sample_descriptors_matches_jax(dtype, legacy):
    rng = np.random.default_rng(7)
    B, Hc, Wc, C, K = 2, 12, 16, 32, 50
    dmap = _pair(rng.normal(size=(B, Hc, Wc, C)), dtype)
    # in-image points plus a few off the edge (zero padding)
    kpts = rng.uniform(-4, 8 * 16 + 4, size=(B, K, 2)).astype(np.float32)
    kpts[..., 1] *= Hc / Wc
    ref = jax_grid_sample.sample_descriptors(jnp.asarray(kpts), dmap[0], 8, legacy_offset=legacy)
    out = grid_sample.sample_descriptors(torch.from_numpy(kpts), dmap[1], 8, legacy_offset=legacy)
    # a bf16 map must not give f32 descriptors
    assert out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(out), _np(ref), atol={"float32": 1e-6, "bfloat16": 8e-3}[dtype])

    pts = torch.from_numpy(kpts / 8)
    np.testing.assert_allclose(
        _np(grid_sample.grid_sample_nd(dmap[1], pts)),
        _np(jax_grid_sample.grid_sample_nd(dmap[0], jnp.asarray(kpts / 8))),
        atol={"float32": 1e-5, "bfloat16": 3e-2}[dtype])
