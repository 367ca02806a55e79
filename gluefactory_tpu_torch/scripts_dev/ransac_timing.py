"""Where a homography RANSAC call's time goes on the card (`ops/ransac.py`).

    python -m gluefactory_tpu_torch.scripts_dev.ransac_timing

Prints one JSON line: for each bucket (the points of one call after
`xla_ransac.bucket_pad`, 60% of them valid), the whole call and its
stages, each timed by `scripts_dev.timing.cuda_time_ms` (CUDA events around
20 calls, so the host's time to issue them counts): the Gumbel noise
(`threefry.gumbel`), the minimal sets' DLT (1024 batched 9 x 9 `eigh`), the
scoring (every point's residual under every hypothesis) and one weighted
refit; then `torch.linalg.eigh` of (1024, 9, 9) alone, beside
`torch.linalg.svd` of (1024, 8, 9) and a batched 8 x 8 `solve`, which give
the same minimal-set homography by other routes. `main(device="cpu")` runs
each stage once and reports no time (the tests).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..geometry.homography import compute_homography_dlt
from ..ops import ransac
from ..utils import threefry
from .timing import card, cuda_time_ms

BUCKETS = (64, 256, 1024)
N_ITERS = 1024


def _inputs(bucket: int, device):
    rng = np.random.default_rng(bucket)
    n = int(0.6 * bucket)
    p0 = rng.uniform(0, 640, (bucket, 2))
    H = np.array([[1.05, 0.04, 12.0], [-0.03, 0.97, -7.0], [2e-4, -1e-4, 1.0]])
    ph = np.c_[p0, np.ones(bucket)] @ H.T
    p1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.3, (bucket, 2))
    p1[n // 2:n] += rng.uniform(-80, 80, (n - n // 2, 2))  # outliers
    valid = np.arange(bucket) < n
    return [torch.from_numpy(x).to(device) for x in (p0.astype(np.float32), p1.astype(np.float32), valid)]


def stages(bucket: int, device) -> dict:
    """Callables of the RANSAC's stages at `bucket` points."""
    p0, p1, valid = _inputs(bucket, device)
    idx = ransac.sample_minimal_sets(0, N_ITERS, 4, valid)
    H_hyp = compute_homography_dlt(p0[idx], p1[idx])
    w = valid.float()
    return {
        "call": lambda: ransac.ransac_homography(p0, p1, valid, 0.5),
        "noise": lambda: threefry.gumbel(0, (N_ITERS, bucket), device=device),
        "minimal_sets": lambda: ransac.sample_minimal_sets(0, N_ITERS, 4, valid),
        "dlt_1024": lambda: compute_homography_dlt(p0[idx], p1[idx]),
        "scoring": lambda: ((ransac.homography_residuals(H_hyp, p0, p1) < 0.25) & valid).sum(-1),
        "refit": lambda: compute_homography_dlt(p0[None], p1[None], w[None]),
    }


def solvers(device) -> dict:
    """eigh of A^T A against other routes to the minimal sets' null vector."""
    g = torch.Generator(device="cpu").manual_seed(0)
    A = torch.randn(N_ITERS, 8, 9, generator=g).to(device)
    AtA = A.transpose(1, 2) @ A
    return {
        "eigh_9x9": lambda: torch.linalg.eigh(AtA),
        "svd_8x9": lambda: torch.linalg.svd(A),
        "solve_8x8": lambda: torch.linalg.solve(A[..., :8], -A[..., 8:]),
    }


def main(device: str = "cuda", buckets=BUCKETS, reps: int = 20) -> dict:
    on_card = torch.device(device).type == "cuda"
    time = (lambda fn: cuda_time_ms(fn, reps)) if on_card else (lambda fn: (fn(), None)[1])
    res = {"n_iters": N_ITERS, "buckets": {}, "card": card(torch.device(device))}
    for bucket in buckets:
        res["buckets"][bucket] = {name: time(fn) for name, fn in stages(bucket, device).items()}
    res["solvers"] = {name: time(fn) for name, fn in solvers(device).items()}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
