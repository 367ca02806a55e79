"""SuperGlue's Sinkhorn kernel: the wrapper of the hand-written CUDA kernel
`csrc/log_sinkhorn.cu`, its plain PyTorch version, and the kernel's plan.

`log_sinkhorn` replaces `gluefactory_tpu/ops/pallas_sinkhorn.py::
log_sinkhorn_pallas`. The TPU kernel is gated to couplings that fit in VMEM
(`sinkhorn_available`); this one runs at every size: one cooperative launch
whose blocks keep their rows of Z in shared memory for every iteration, and
read from device memory on each pass the rows that do not fit
(`sinkhorn_plan`).

Dispatch is by device alone: a CUDA tensor goes to the kernel, which is
built at first use (`_build.py`) and raises if it does not build or launch;
a CPU tensor goes to `plain_log_sinkhorn`. With autograd recording and an
input that requires a gradient, the kernel's output carries the plain
loop's gradient (`_autograd.py`). `launches` counts wrapper calls that
launched the kernel (one call runs all the iterations).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._autograd import kernel_with_plain_grad, needs_grad
from ._build import uses_kernel

launches = {"log_sinkhorn": 0}

MAX_BLOCKS = 256  # blocks an item (the merge holds 8 partials a thread)
STATIC_SMEM = 4096  # shared memory the kernel declares itself (its merge's scratch), rounded up

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 10 + [_P]


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


def sinkhorn_plan(B: int, M: int, N: int, sm_count: int,
                  smem_bytes: int = _build.MAX_SHARED_BYTES - STATIC_SMEM) -> dict:
    """How the kernel lays Z (B, M, N) over `sm_count` blocks of at most
    `smem_bytes` of shared memory: `groups` items at once (the most whose
    rows all fit on chip, at least 1), `blocks` blocks an item (at most
    MAX_BLOCKS), `rows` whole rows a block (every block has at least one),
    the first `resident` of them held in shared memory for every iteration
    (padded to a multiple of 4 floats) and the other `streamed` read from
    device memory on each pass. v and the block's column LSEs (N floats
    each) are kept in shared memory when v takes at most a quarter of it
    (`v_shared`), and u and its last change (`rows` floats each) always.
    `smem` is a block's dynamic shared memory in bytes."""
    if min(B, M, N, sm_count) <= 0:
        raise ValueError(f"sinkhorn_plan: B {B}, M {M}, N {N}, sm_count {sm_count} must be positive")
    ldz = -(-N // 4) * 4
    v_shared = 4 * ldz <= smem_bytes // 4

    def fixed(rows: int) -> int:  # v and the column LSEs, u and its change
        return 4 * ((2 * ldz if v_shared else 0) + 2 * rows)

    def layout(groups: int) -> tuple[int, int]:
        blocks = min(sm_count // groups, M, MAX_BLOCKS)
        rows = -(-M // blocks)
        return -(-M // rows), rows

    groups = 1
    for g in range(min(B, sm_count), 1, -1):
        blocks, rows = layout(g)
        if rows * 4 * ldz + fixed(rows) <= smem_bytes:
            groups = g
            break
    blocks, rows = layout(groups)
    resident = max(0, min(rows, (smem_bytes - fixed(rows)) // (4 * ldz)))
    return {"groups": groups, "blocks": blocks, "rows": rows, "resident": resident,
            "streamed": rows - resident, "v_shared": v_shared, "grid": groups * blocks,
            "smem": 4 * resident * ldz + fixed(rows)}


def _launch(Z, log_mu, log_nu, iters: int) -> torch.Tensor:
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
    fn = _build.function("log_sinkhorn", _ARGTYPES)
    sms = torch.cuda.get_device_properties(Z.device).multi_processor_count
    plan = sinkhorn_plan(B, M, N, sms)
    # v (B, N) and the grid barrier's counter, zeroed by one fill
    scratch = torch.zeros(B * N + 1, dtype=torch.float32, device=Z.device)
    part = torch.empty(2, plan["grid"], N, dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = fn(Z.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(), scratch.data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), scratch[B * N:].data_ptr(), out.data_ptr(),
                B, M, N, int(iters), plan["groups"], plan["blocks"], plan["rows"], plan["resident"],
                int(plan["v_shared"]), plan["smem"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"log_sinkhorn: kernel launch failed (cudaError {rc})")
    launches["log_sinkhorn"] += 1
    return out


def log_sinkhorn(Z, log_mu, log_nu, iters: int) -> torch.Tensor:
    """Z (B,M,N), log_mu (B,M), log_nu (B,N) -> Z + u + v (B,M,N) f32. CUDA
    tensors run csrc/log_sinkhorn.cu; CPU tensors `plain_log_sinkhorn`."""
    if not uses_kernel(Z.device):
        return plain_log_sinkhorn(Z, log_mu, log_nu, iters)
    if needs_grad(Z, log_mu, log_nu):
        return kernel_with_plain_grad(_launch, plain_log_sinkhorn, Z, log_mu, log_nu, iters)
    return _launch(Z, log_mu, log_nu, iters)
