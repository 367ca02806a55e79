"""Assignment heads and match filtering (counterpart of
`gluefactory_tpu/ops/assignment.py`): LightGlue's
`sigmoid_log_double_softmax`, GlueStick's `log_double_softmax`, SuperGlue's log-domain optimal transport
(`log_sinkhorn_iterations`, `log_optimal_transport`), `filter_matches`, and
the nearest-neighbour matcher's `find_nn` and `mutual_check`.

Mask-aware: padded keypoints get -1e9 scores and never match (-1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_sinkhorn import log_sinkhorn, plain_log_sinkhorn

NEG_INF = -1e9


def _mask_sim(sim, mask0, mask1):
    if mask0 is not None:
        sim = sim.masked_fill(~mask0[..., :, None], NEG_INF)
    if mask1 is not None:
        sim = sim.masked_fill(~mask1[..., None, :], NEG_INF)
    return sim


def sigmoid_log_double_softmax(sim, z0, z1, mask0=None, mask1=None) -> torch.Tensor:
    """(B,M,N) similarity + matchability logits z0 (B,M), z1 (B,N) ->
    (B,M+1,N+1) log assignment:

    scores[:M,:N] = log_softmax_rows + log_softmax_cols + logsig(z0) + logsig(z1)
    scores[:, N]  = logsig(-z0);  scores[M, :] = logsig(-z1).
    """
    B, M, N = sim.shape
    certainties = F.logsigmoid(z0)[..., :, None] + F.logsigmoid(z1)[..., None, :]
    simm = _mask_sim(sim, mask0, mask1)
    inner = simm.log_softmax(2) + simm.log_softmax(1) + certainties
    inner = _mask_sim(inner, mask0, mask1)
    un0 = F.logsigmoid(-z0)
    un1 = F.logsigmoid(-z1)
    if mask0 is not None:
        un0 = un0.masked_fill(~mask0, NEG_INF)
    if mask1 is not None:
        un1 = un1.masked_fill(~mask1, NEG_INF)
    scores = sim.new_full((B, M + 1, N + 1), NEG_INF)
    scores[:, :M, :N] = inner
    scores[:, :M, N] = un0
    scores[:, M, :N] = un1
    return scores


def log_double_softmax(sim, bin_score, mask0=None, mask1=None) -> torch.Tensor:
    """GlueStick's assignment: (B,M,N) similarity and a learned dustbin score
    -> (B,M+1,N+1). A dustbin column and row are appended, a log-softmax
    taken along each axis, and the two averaged; scores[M, N] is NEG_INF."""
    B, M, N = sim.shape
    sim = _mask_sim(sim, mask0, mask1)
    bin_ = bin_score.to(sim.dtype).reshape(1, 1, 1)
    scores0 = torch.cat([sim, bin_.expand(B, M, 1)], dim=2).log_softmax(2)  # (B, M, N+1)
    scores1 = torch.cat([sim, bin_.expand(B, 1, N)], dim=1).log_softmax(1)  # (B, M+1, N)
    scores = sim.new_full((B, M + 1, N + 1), NEG_INF)
    scores[:, :M, :N] = (scores0[:, :, :N] + scores1[:, :M, :]) / 2.0
    scores[:, :M, N] = scores0[:, :, N]
    scores[:, M, :N] = scores1[:, M, :]
    return scores


def log_sinkhorn_iterations(Z, log_mu, log_nu, iters: int, flash: bool = True) -> torch.Tensor:
    """Log-domain Sinkhorn normalisation, f32: the CUDA kernel
    (`cuda_sinkhorn.log_sinkhorn`) for a CUDA tensor at every size, the plain
    loop for a CPU tensor or with `flash=False`."""
    if flash:
        return log_sinkhorn(Z, log_mu, log_nu, iters)
    return plain_log_sinkhorn(Z, log_mu, log_nu, iters)


def log_optimal_transport(scores, bin_score, iters: int, mask0=None, mask1=None,
                          flash: bool = True) -> torch.Tensor:
    """Optimal transport with dustbins in log space: scores (B,M,N) ->
    (B,M+1,N+1) f32 log assignment, whatever the input dtype. Every real
    point has mass 1 and the bins absorb the rest; norm = -log(ms + ns) from
    the mask counts. Padded rows and columns get -1e9 couplings and
    marginals, so they carry no mass."""
    scores = scores.float()
    B, M, N = scores.shape
    ms = mask0.sum(-1).float() if mask0 is not None else scores.new_full((B,), float(M))
    ns = mask1.sum(-1).float() if mask1 is not None else scores.new_full((B,), float(N))
    bin_score = torch.as_tensor(bin_score, device=scores.device).float()
    couplings = bin_score.expand(B, M + 1, N + 1).clone()
    couplings[:, :M, :N] = _mask_sim(scores, mask0, mask1)

    norm = -torch.log(ms + ns)  # (B,)
    log_mu = torch.cat([norm[:, None].expand(B, M), (torch.log(ns) + norm)[:, None]], dim=1)
    log_nu = torch.cat([norm[:, None].expand(B, N), (torch.log(ms) + norm)[:, None]], dim=1)
    if mask0 is not None:
        log_mu[:, :M] = log_mu[:, :M].masked_fill(~mask0, NEG_INF)
    if mask1 is not None:
        log_nu[:, :N] = log_nu[:, :N].masked_fill(~mask1, NEG_INF)
    Z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iters, flash=flash)
    return Z - norm[:, None, None]


def filter_matches(scores: torch.Tensor, th: float, mask0=None, mask1=None):
    """Mutual-nearest + threshold matches from an (M+1, N+1) log assignment.

    Returns (matches0 (B,M), matches1 (B,N) int32, -1 if unmatched or
    invalid; mscores0 (B,M), mscores1 (B,N))."""
    inner = scores[:, :-1, :-1]
    B, M, N = inner.shape
    max0, m0 = inner.max(dim=2)
    _, m1 = inner.max(dim=1)
    ar0 = torch.arange(M, device=scores.device)[None]
    ar1 = torch.arange(N, device=scores.device)[None]
    mutual0 = ar0 == m1.gather(1, m0)
    mutual1 = ar1 == m0.gather(1, m1)
    mscores0 = torch.where(mutual0, max0.exp(), torch.zeros_like(max0))
    mscores1 = torch.where(mutual1, mscores0.gather(1, m1), torch.zeros_like(mscores0[:, :1]))
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & valid0.gather(1, m1)
    if mask0 is not None:
        valid0 = valid0 & mask0
        mscores0 = mscores0 * mask0
    if mask1 is not None:
        valid1 = valid1 & mask1
        mscores1 = mscores1 * mask1
    matches0 = torch.where(valid0, m0, -1).to(torch.int32)
    matches1 = torch.where(valid1, m1, -1).to(torch.int32)
    return matches0, matches1, mscores0, mscores1


def _top2(sim):
    """The two largest entries of the last axis and their indices, the
    lower index first among equal values (as `jax.lax.top_k`)."""
    v0, i0 = sim.max(dim=-1)
    rest = sim.scatter(-1, i0[..., None], float("-inf"))
    v1, i1 = rest.max(dim=-1)
    return torch.stack([v0, v1], -1), torch.stack([i0, i1], -1)


def find_nn(sim, ratio_th=None, distance_th=None, mask0=None, mask1=None):
    """Nearest neighbours over a cosine-similarity matrix (B, M, N) along its
    last axis, with Lowe's ratio test and a distance threshold on the
    distances 2 (1 - sim): (matches (B, M) int32, -1 where a test fails;
    scores (sim + 1) / 2, 0 there)."""
    sim = _mask_sim(sim, mask0, mask1)
    sim_nn, ind_nn = _top2(sim)
    dist_nn = 2.0 * (1.0 - sim_nn)
    mask = torch.ones_like(sim_nn[..., 0], dtype=torch.bool)
    if ratio_th is not None:
        mask = mask & (dist_nn[..., 0] <= (ratio_th**2) * dist_nn[..., 1])
    if distance_th is not None:
        mask = mask & (dist_nn[..., 0] <= distance_th**2)
    matches = torch.where(mask, ind_nn[..., 0], -1)
    scores = torch.where(mask, (sim_nn[..., 0] + 1) / 2.0, torch.zeros_like(sim_nn[..., 0]))
    return matches.to(torch.int32), scores


def mutual_check(m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """m0 where its target points back to it in m1, else -1; an unmatched
    entry (-1) reads m1 at index 0 and stays -1."""
    inds0 = torch.arange(m0.shape[-1], device=m0.device)[None]
    loop = m1.gather(-1, m0.clamp(0, m1.shape[-1] - 1).long())
    ok = (m0 >= 0) & (inds0 == loop)
    return torch.where(ok, m0, -1).to(m0.dtype)
