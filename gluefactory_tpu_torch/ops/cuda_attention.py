"""LightGlue's two attention kernels: the wrappers of the hand-written CUDA
kernels in `csrc/`, and their plain PyTorch versions.

- `fused_attention` (csrc/fused_attention.cu) replaces
  `gluefactory_tpu/ops/pallas_attention.py::fused_attention`;
- `fused_bidirectional_attention` (csrc/fused_bidirectional_attention.cu)
  replaces `...::fused_bidirectional_attention`.

Dispatch is by device alone: a CUDA tensor goes to the kernel, which is
built at first use (`_build.py`) and raises if it does not build or launch;
a CPU tensor goes to the plain version. With autograd recording and an
input that requires a gradient, the kernel's output carries the plain
version's gradient (`_autograd.py`, as the JAX package's custom VJPs
recompute a jnp reference). `launches` counts kernel launches per wrapper
so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._autograd import kernel_with_plain_grad, needs_grad
from ._build import uses_kernel

NEG_INF = -1e9
HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"fused_attention": 0, "fused_bidirectional_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the jnp reference semantics of ops/attention.py)
# ---------------------------------------------------------------------------


def attention_plain(q, k, v, mask_k=None, mask_q=None):
    """Masked softmax(q k^T / sqrt(D)) v with f32 logits, softmax and PV.

    q (B,H,M,D), k/v (B,H,N,D); masks (B,N) / (B,M), nonzero = valid.
    A fully masked key set gives zeros; masked query rows are zeroed."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhmd,bhnd->bhmn", q.float(), k.float()) * scale
    if mask_k is not None:
        mk = mask_k.bool()
        logits = logits.masked_fill(~mk[:, None, None, :], NEG_INF)
    attn = logits.softmax(-1)
    if mask_k is not None:
        attn = attn * mk.any(-1)[:, None, None, None]
    out = torch.einsum("bhmn,bhnd->bhmd", attn, v.float())
    if mask_q is not None:
        out = out * mask_q.bool()[:, None, :, None]
    return out.to(q.dtype)


def bidirectional_plain(qk0, qk1, v0, v1, mask0=None, mask1=None):
    """Shared-QK cross-attention both ways from sim = qk0 qk1^T / sqrt(D):
    m0 = rowsoftmax(sim masked by mask1) v1, m1 = colsoftmax(sim masked by
    mask0)^T v0, in f32; fully masked opposite sets give zeros and masked
    query rows are zeroed."""
    scale = 1.0 / math.sqrt(qk0.shape[-1])
    sim = torch.einsum("bhmd,bhnd->bhmn", qk0.float(), qk1.float()) * scale
    sim01, sim10 = sim, sim
    if mask1 is not None:
        sim01 = sim.masked_fill(~mask1.bool()[:, None, None, :], NEG_INF)
    if mask0 is not None:
        sim10 = sim.masked_fill(~mask0.bool()[:, None, :, None], NEG_INF)
    attn01 = sim01.softmax(-1)
    attn10 = sim10.softmax(-2)
    if mask1 is not None:
        attn01 = attn01 * mask1.bool().any(-1)[:, None, None, None]
    if mask0 is not None:
        attn10 = attn10 * mask0.bool().any(-1)[:, None, None, None]
    m0 = torch.einsum("bhmn,bhnd->bhmd", attn01, v1.float())
    m1 = torch.einsum("bhmn,bhmd->bhnd", attn10, v0.float())
    if mask0 is not None:
        m0 = m0 * mask0.bool()[:, None, :, None]
    if mask1 is not None:
        m1 = m1 * mask1.bool()[:, None, :, None]
    return m0.to(qk0.dtype), m1.to(qk0.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fused_attention": [_P] * 6 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 5
    + [ctypes.c_float, _I, _P],
    "fused_bidirectional_attention": [_P] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    + [_I] * 5 + [ctypes.c_float, _I, _P],
}


def _kernel(name: str):
    return _build.function(name, _SIGNATURES[name])


def f32_blocks_per_sm(head_dim: int) -> int:
    """Blocks of the f32 body that one SM holds at once (the CUDA occupancy
    calculator on the built kernel; needs a CUDA device)."""
    fn = getattr(_build.load("fused_attention"), "gf_fused_attention_f32_blocks_per_sm")
    fn.argtypes, fn.restype = [_I], _I
    return int(fn(head_dim))


def _check(name: str, tensors: list, masks: list) -> None:
    ref = tensors[0]
    if ref.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported (float32, bfloat16)")
    if ref.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {ref.shape[-1]} not supported {HEAD_DIMS}")
    for t in tensors:
        if t.dim() != 4 or t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: inputs must be 4-D of one dtype on one device")
        if t.shape[0] != ref.shape[0] or t.shape[1] != ref.shape[1] or t.shape[3] != ref.shape[3]:
            raise ValueError(f"{name}: inconsistent shapes {[tuple(x.shape) for x in tensors]}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the feature dimension must be contiguous")
    for mask, n in masks:
        if mask is not None and (tuple(mask.shape) != (ref.shape[0], n) or mask.device != ref.device):
            raise ValueError(f"{name}: mask of shape {tuple(mask.shape)}, expected {(ref.shape[0], n)}")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a contiguous copy: the bf16 kernel reads by TMA, which needs a
    16-byte aligned base pointer and, for every dimension but the last that
    has more than one element, a positive stride of a multiple of 16 bytes.
    LightGlue's (B, N, H, D)-ordered views pass as they are."""
    esize = t.element_size()
    ok = t.data_ptr() % 16 == 0 and all(
        n == 1 or (s > 0 and s * esize % 16 == 0) for n, s in zip(t.shape[:-1], t.stride()[:-1])
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _mask_arg(mask):
    """(mask as contiguous uint8, nonzero = valid, or None; its batch
    stride). A bool mask is read in place as bytes of 0 or 1 (no kernel
    runs unless it is not contiguous); other dtypes are converted."""
    if mask is None:
        return None, 0
    if mask.dtype == torch.bool:
        m = mask.contiguous().view(torch.uint8)
    else:
        m = (mask != 0).to(torch.uint8).contiguous()
    return m, m.stride(0)


def _empty_heads(B: int, H: int, n: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """(B,H,n,D) output laid out as (B,n,H,D), so merging heads is a view."""
    return torch.empty(B, n, H, D, dtype=like.dtype, device=like.device).transpose(1, 2)


def _bhn(t: torch.Tensor) -> list:
    """(batch, head, token) strides in elements. A dimension of one element,
    whose stride no index reaches, gets 16 bytes' worth: a TMA tensor map
    takes no other."""
    unit = 16 // t.element_size()
    return [s if n > 1 else unit for n, s in zip(t.shape[:3], t.stride()[:3])]


def fused_attention(q, k, v, mask_k=None, mask_q=None):
    """q (B,H,M,D), k/v (B,H,N,D); mask_k (B,N), mask_q (B,M) bool or int,
    nonzero = valid -> (B,H,M,D). CUDA tensors run csrc/fused_attention.cu;
    CPU tensors run `attention_plain`."""
    if not uses_kernel(q.device):
        return attention_plain(q, k, v, mask_k, mask_q)
    if needs_grad(q, k, v):
        return kernel_with_plain_grad(_attention_kernel, attention_plain, q, k, v, mask_k, mask_q)
    return _attention_kernel(q, k, v, mask_k, mask_q)


def _attention_kernel(q, k, v, mask_k, mask_q):
    B, H, M, D = q.shape
    N = k.shape[2]
    _check("fused_attention", [q, k, v], [(mask_k, N), (mask_q, M)])
    out = _empty_heads(B, H, M, D, q)
    if out.numel() == 0 or N == 0:
        return out.zero_()
    q, k, v = (_tma_ready(t) for t in (q, k, v))
    mk, mk_sb = _mask_arg(mask_k)
    mq, mq_sb = _mask_arg(mask_q)
    strides = _bhn(q) + _bhn(k) + _bhn(v) + _bhn(out) + [mk_sb, mq_sb]
    fn = _kernel("fused_attention")
    with torch.cuda.device(q.device):
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mk is None else mk.data_ptr(),
            None if mq is None else mq.data_ptr(),
            out.data_ptr(), (ctypes.c_longlong * 14)(*strides),
            B, H, M, N, D, 1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_attention: kernel launch failed (cudaError {rc})")
    launches["fused_attention"] += 1
    return out


def fused_bidirectional_attention(qk0, qk1, v0, v1, mask0=None, mask1=None):
    """qk0/v0 (B,H,M,D), qk1/v1 (B,H,N,D); masks (B,M)/(B,N) bool or int ->
    (m0 (B,H,M,D), m1 (B,H,N,D)). CUDA tensors run
    csrc/fused_bidirectional_attention.cu; CPU tensors `bidirectional_plain`."""
    if not uses_kernel(qk0.device):
        return bidirectional_plain(qk0, qk1, v0, v1, mask0, mask1)
    if needs_grad(qk0, qk1, v0, v1):
        return kernel_with_plain_grad(_bidirectional_kernel, bidirectional_plain,
                                      qk0, qk1, v0, v1, mask0, mask1)
    return _bidirectional_kernel(qk0, qk1, v0, v1, mask0, mask1)


def _bidirectional_kernel(qk0, qk1, v0, v1, mask0, mask1):
    B, H, M, D = qk0.shape
    N = qk1.shape[2]
    _check("fused_bidirectional_attention", [qk0, qk1, v0, v1], [(mask0, M), (mask1, N)])
    if v0.shape[2] != M or v1.shape[2] != N:
        raise ValueError("fused_bidirectional_attention: v0/v1 token counts differ from qk0/qk1")
    out0 = _empty_heads(B, H, M, D, qk0)
    out1 = _empty_heads(B, H, N, D, qk0)
    if out0.numel() == 0 or out1.numel() == 0:
        return out0.zero_(), out1.zero_()
    qk0, qk1, v0, v1 = (_tma_ready(t) for t in (qk0, qk1, v0, v1))
    m0, m0_sb = _mask_arg(mask0)
    m1, m1_sb = _mask_arg(mask1)
    strides = (
        _bhn(qk0) + _bhn(qk1) + _bhn(v0) + _bhn(v1) + _bhn(out0) + _bhn(out1)
        + [m0_sb, m1_sb]
    )
    fn = _kernel("fused_bidirectional_attention")
    with torch.cuda.device(qk0.device):
        rc = fn(
            qk0.data_ptr(), qk1.data_ptr(), v0.data_ptr(), v1.data_ptr(),
            None if m0 is None else m0.data_ptr(),
            None if m1 is None else m1.data_ptr(),
            out0.data_ptr(), out1.data_ptr(), (ctypes.c_longlong * 20)(*strides),
            B, H, M, N, D, 1.0 / math.sqrt(D), _DTYPE_CODES[qk0.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_bidirectional_attention: kernel launch failed (cudaError {rc})")
    launches["fused_bidirectional_attention"] += 1
    return out0, out1
