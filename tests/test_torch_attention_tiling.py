"""A CPU rehearsal of the f32 attention body's order of work
(`csrc/attention_tile.cuh`, `attention_f32_kernel`), which cannot run here:
a torch emulation of its tile walk against `attention_plain` and
`bidirectional_plain`, within 1e-5.

The emulation does what a block does: 128-row query tiles and 64-key tiles,
tokens past the end zero-filled (cp.async's zero fill) and their keys
invalid, a key tile with no valid key skipped whole, the online softmax in
the log2 domain with exp2 (running max m, row sum l and output O rescaled
by exp2((m_old - m_new) * scale * log2 e) each tile), and at the end O / l
on the rows whose query mask is set and whose l > 0, zeros elsewhere. The
cross-attention runs it twice, as blockIdx.z does: queries qk0 over keys
qk1 with values v1, and queries qk1 over keys qk0 with values v0.
"""

import math

import numpy as np
import pytest
import torch

from gluefactory_tpu_torch.ops.cuda_attention import attention_plain, bidirectional_plain

ROWS, KEYS = 128, 64  # kF32Rows, kF32Keys
LOG2E = 1.4426950408889634
TOL = 1e-5


def _padded(x, n):
    """x (..., t, D) with zero rows appended up to n tokens."""
    return torch.cat([x, x.new_zeros(*x.shape[:-2], n - x.shape[-2], x.shape[-1])], -2)


def tiled_attention(q, k, v, mask_k=None, mask_q=None, skipped=None):
    """The f32 body's tile walk over q (B,H,M,D), k/v (B,H,N,D), in f32.
    `skipped` (a list) collects (batch, key tile) of every skipped tile."""
    B, H, M, D = q.shape
    N = k.shape[2]
    sl2 = 1.0 / math.sqrt(D) * LOG2E
    mk = torch.ones(B, N, dtype=torch.bool) if mask_k is None else mask_k.bool()
    mq = torch.ones(B, M, dtype=torch.bool) if mask_q is None else mask_q.bool()
    n_tiles = -(-N // KEYS)
    kp, vp = _padded(k.float(), n_tiles * KEYS), _padded(v.float(), n_tiles * KEYS)
    key_ok = torch.cat([mk, mk.new_zeros(B, n_tiles * KEYS - N)], 1)  # tail keys invalid
    out = torch.zeros(B, H, M, D)
    for b in range(B):
        for r0 in range(0, M, ROWS):
            qt = _padded(q[b, :, r0:r0 + ROWS].float(), ROWS)  # (H, 128, D), zero-filled
            m = torch.full((H, ROWS, 1), -math.inf)
            l = torch.zeros(H, ROWS, 1)
            o = torch.zeros(H, ROWS, D)
            for jt in range(n_tiles):
                keys = slice(jt * KEYS, (jt + 1) * KEYS)
                ok = key_ok[b, keys]
                if not ok.any():  # uniform over the block: skip the tile
                    if skipped is not None and r0 == 0:
                        skipped.append((b, jt))
                    continue
                s = qt @ kp[b, :, keys].transpose(-1, -2)  # (H, 128, 64)
                s = s.masked_fill(~ok, -math.inf)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))  # finite: a valid key
                alpha = torch.exp2((m - m_new) * sl2)  # 0 on the first tile
                p = torch.exp2(s * sl2 - m_new * sl2)  # masked keys: exactly 0
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha + p @ vp[b, :, keys]
                m = m_new
            rows = min(ROWS, M - r0)  # the tail tile's rows past M are not written
            keep = mq[b, r0:r0 + rows][None, :, None] & (l[:, :rows] > 0)
            inv = torch.where(keep, 1.0 / l[:, :rows].clamp_min(1e-30), torch.zeros(()))
            out[b, :, r0:r0 + rows] = o[:, :rows] * inv
    return out


def tiled_bidirectional(qk0, qk1, v0, v1, mask0=None, mask1=None, skipped=None):
    return (tiled_attention(qk0, qk1, v1, mask1, mask0, skipped),
            tiled_attention(qk1, qk0, v0, mask0, mask1, skipped))


def _inputs(B, H, M, N, D, seed):
    rng = np.random.default_rng(seed)
    t = lambda n: torch.from_numpy(rng.normal(size=(B, H, n, D)).astype(np.float32))  # noqa: E731
    masks = {
        "partial": (torch.from_numpy(rng.uniform(size=(B, M)) > 0.3),
                    torch.from_numpy(rng.uniform(size=(B, N)) > 0.3)),
        "side0_masked": (torch.zeros(B, M, dtype=torch.bool),
                         torch.from_numpy(rng.uniform(size=(B, N)) > 0.3)),
        "side1_masked": (torch.from_numpy(rng.uniform(size=(B, M)) > 0.3),
                         torch.zeros(B, N, dtype=torch.bool)),
    }
    return t(M), t(N), t(M), t(N), masks


M, N = 77, 129  # a tail in both tiles: 77 < 128 query rows, 129 = 2 * 64 + 1 keys


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("case", ["partial", "side1_masked"])
def test_tile_walk_matches_attention_plain(D, case):
    q, k, _, v, masks = _inputs(2, 2, M, N, D, seed=M + N + D)
    m0, m1 = masks[case]
    got = tiled_attention(q, k, v, m1, m0)
    want = attention_plain(q, k, v, m1, m0)
    assert got.shape == want.shape == (2, 2, M, D)
    assert float((got - want).abs().max()) <= TOL
    if case == "side1_masked":  # no valid key: every tile skipped, zeros
        assert not got.abs().any()


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("case", ["partial", "side0_masked"])
def test_tile_walk_matches_bidirectional_plain(D, case):
    qk0, qk1, v0, v1, masks = _inputs(2, 2, M, N, D, seed=3 * M + N + D)
    m0, m1 = masks[case]
    got = tiled_bidirectional(qk0, qk1, v0, v1, m0, m1)
    want = bidirectional_plain(qk0, qk1, v0, v1, m0, m1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= TOL
        if case == "side0_masked":  # side 0's queries masked, side 1's keys all masked: zeros
            assert not g.abs().any()


def test_masked_query_row_and_skipped_tiles():
    """A masked query row is zero; keys valid only inside one 64-key tile in
    the middle make every other tile skipped, and the result is still the
    plain version's."""
    q, k, _, v, _ = _inputs(2, 2, 150, 300, 64, seed=11)
    mq = torch.ones(2, 150, dtype=torch.bool)
    mq[0, 7] = mq[1, 149] = False
    mk = torch.zeros(2, 300, dtype=torch.bool)
    mk[:, 128:192] = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 64)) > 0.5)
    mk[:, 130] = True
    skipped = []
    got = tiled_attention(q, k, v, mk, mq, skipped)
    assert sorted(skipped) == [(b, jt) for b in range(2) for jt in (0, 1, 3, 4)]
    assert not got[0, :, 7].any() and not got[1, :, 149].any()
    assert float((got - attention_plain(q, k, v, mk, mq)).abs().max()) <= TOL
