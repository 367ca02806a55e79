"""SuperGlue's Sinkhorn kernel: the wrapper of the hand-written CUDA kernel
`csrc/log_sinkhorn.cu` and its plain PyTorch version.

`log_sinkhorn` replaces `gluefactory_tpu/ops/pallas_sinkhorn.py::
log_sinkhorn_pallas`. The TPU kernel is gated to couplings that fit in VMEM
(`sinkhorn_available`); this one runs at every size.

Dispatch is by device alone: a CUDA tensor goes to the kernel, which is
built at first use (`_build.py`) and raises if it does not build or launch;
a CPU tensor goes to `plain_log_sinkhorn`. `launches` counts wrapper calls
that launched the kernel (one call runs all the iterations).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import uses_kernel

launches = {"log_sinkhorn": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_P]


def reset_launches() -> None:
    launches["log_sinkhorn"] = 0


def plain_log_sinkhorn(Z, log_mu, log_nu, iters: int) -> torch.Tensor:
    """`iters` rounds of u = log_mu - LSE_rows(Z + v), v = log_nu -
    LSE_cols(Z + u) from u = v = 0, in f32; returns Z + u + v. The loop of
    `gluefactory_tpu/ops/assignment.py::log_sinkhorn_iterations`."""
    Z, log_mu, log_nu = Z.float(), log_mu.float(), log_nu.float()
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_sinkhorn(Z, log_mu, log_nu, iters: int) -> torch.Tensor:
    """Z (B,M,N), log_mu (B,M), log_nu (B,N) -> Z + u + v (B,M,N) f32. CUDA
    tensors run csrc/log_sinkhorn.cu; CPU tensors `plain_log_sinkhorn`."""
    if not uses_kernel(Z.device):
        return plain_log_sinkhorn(Z, log_mu, log_nu, iters)
    if Z.dim() != 3:
        raise ValueError(f"log_sinkhorn: Z must be (B, M, N), got {tuple(Z.shape)}")
    B, M, N = Z.shape
    if tuple(log_mu.shape) != (B, M) or tuple(log_nu.shape) != (B, N):
        raise ValueError(f"log_sinkhorn: marginals {tuple(log_mu.shape)}, {tuple(log_nu.shape)} "
                         f"do not fit Z {tuple(Z.shape)}")
    if log_mu.device != Z.device or log_nu.device != Z.device:
        raise ValueError("log_sinkhorn: inputs on different devices")
    if iters < 0:
        raise ValueError(f"log_sinkhorn: iters {iters} < 0")
    Z = Z.float().contiguous()
    log_mu = log_mu.float().contiguous()
    log_nu = log_nu.float().contiguous()
    out = torch.empty_like(Z)
    if Z.numel() == 0:
        return out
    u = torch.zeros(B, M, dtype=torch.float32, device=Z.device)
    v = torch.zeros(B, N, dtype=torch.float32, device=Z.device)
    fn = _build.function("log_sinkhorn", _ARGTYPES)
    with torch.cuda.device(Z.device):
        rc = fn(Z.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), u.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, M, N, int(iters), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"log_sinkhorn: kernel launch failed (cudaError {rc})")
    launches["log_sinkhorn"] += 1
    return out
