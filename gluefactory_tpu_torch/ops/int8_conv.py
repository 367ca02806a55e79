"""int8 serving path: SuperPoint's `quantize: int8` convolutions and
LightGlue's `int8_similarity` product (counterpart of
`gluefactory_tpu/ops/int8_conv.py` and of the int8 einsum in
`gluefactory_tpu/models/matchers/lightglue.py::MatchAssignment`).

  - `quantize_weight`: per-output-channel symmetric int8, the scale
    max|w| over (kh, kw, Cin), floored at 1e-12, over 127;
  - `quantize_activation`: dynamic per-tensor symmetric int8, one scale
    over the whole batch (so one image's codes depend on the others);
  - `int8_conv`: s8 x s8 -> s32 conv (SAME, stride 1), then
    y = (f32(acc) * (s_x * s_w)) + b, ReLU, and either the int8 codes of y
    with their new scale, or y as bf16; `pool=True` adds the 2x2 int8 max
    pool that follows the layer (`int8_max_pool`);
  - `quantize_rows` and `int8_bmm`: LightGlue's per-token quantization and
    the int8 similarity, dequantized by the outer product of the row scales.

The divisions by the constant 127 are products with its f32 reciprocal:
XLA rewrites the JAX package's `/ 127.0` so, and the port follows the
compiled JAX function. The constants are Python floats that hold f32
values (PyTorch computes a float tensor's product with a scalar in f32).
Each scale is a device tensor, never read on the host.

Dispatch (`_build.uses_kernel`): CUDA tensors go to the hand-written
kernel `csrc/int8_conv.cu` (no Pallas kernel is replaced; PyTorch has no
CUDA int8 conv), which raises if it does not build or launch or does not
take a shape; CPU tensors to the plain versions. The plain conv computes
in float64, exact here (|acc| <= 9 * 256 * 127^2 < 2^53; float32 is not,
and `F.conv2d` takes no int8); the plain similarity in float32, exact for
D <= 1040 (|acc| <= D * 127^2 < 2^24). `launches` counts the kernel
launches: `int8_conv` the conv, `int8_requant` its second pass (the codes
or the bf16 output), `int8_bmm` the similarity.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ._autograd import kernel_with_plain_grad, needs_grad
from ._build import uses_kernel

launches = {"int8_conv": 0, "int8_requant": 0, "int8_bmm": 0}

INV_127 = float(np.float32(1) / np.float32(127))  # the f32 reciprocal XLA multiplies by
TINY = 1e-12  # the scales' floor
K_ALIGN = 64  # the kernel's K step: packed weight rows are padded to it

_P = ctypes.c_void_p
_I = ctypes.c_int
_CONV_ARGS = [_P] * 8 + [_I] * 9 + [_P]
_REQUANT_ARGS = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P]
_BMM_ARGS = [_P, _P, _P, _P, ctypes.c_float, _P, _I, _I, _I, _I, _P]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _entry(symbol: str, argtypes: list):
    """Entry point `symbol` of the int8 library (built at first use)."""
    fn = getattr(_build.load("int8_conv"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def quantize_weight(w: torch.Tensor):
    """HWIO kernel (kh, kw, Cin, Cout) -> (w8 int8 HWIO, s_w f32 (Cout,))."""
    w = w.float()
    s_w = w.abs().amax(dim=(0, 1, 2)).clamp_min(TINY) * INV_127
    w8 = torch.round(w / s_w).clamp(-127, 127).to(torch.int8)
    return w8, s_w


def quantize_activation(x: torch.Tensor):
    """Any tensor -> (x8 int8, s_x f32 0-d): one scale over all of x."""
    s_x = x.abs().amax().float().clamp_min(TINY) * INV_127
    x8 = torch.round(x.float() / s_x).clamp(-127, 127).to(torch.int8)
    return x8, s_x


def quantize_rows(x: torch.Tensor):
    """(..., D) -> (q int8 (..., D), s f32 (...)): a scale a row, max|x| /
    127 floored at 1e-12 (LightGlue's per-token quantization)."""
    x = x.float()
    s = (x.abs().amax(dim=-1, keepdim=True) * INV_127).clamp_min(TINY)
    q = torch.round(x / s).clamp(-127, 127).to(torch.int8)
    return q, s[..., 0]


@dataclass
class PackedWeight:
    """A conv's weight quantized once: `w8` (kh, kw, Cin, Cout) int8 for the
    plain version, `packed` (Cout, Kp) int8 for the kernel (K ordered (ky,
    kx, cin), zero to Kp, a multiple of 64), `s_w` (Cout,) f32."""

    w8: torch.Tensor
    packed: torch.Tensor
    s_w: torch.Tensor

    @property
    def ksize(self) -> int:
        return self.w8.shape[0]

    @property
    def cin(self) -> int:
        return self.w8.shape[2]

    @property
    def cout(self) -> int:
        return self.w8.shape[3]


def pack_weight(w: torch.Tensor) -> PackedWeight:
    """Quantize an HWIO kernel and lay it out for the kernel."""
    kh, kw, cin, cout = w.shape
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"int8_conv: square odd kernels only (SAME, stride 1), got {kh} x {kw}")
    w8, s_w = quantize_weight(w)
    k = kh * kw * cin
    kp = -(-k // K_ALIGN) * K_ALIGN
    packed = torch.zeros(cout, kp, dtype=torch.int8, device=w.device)
    packed[:, :k] = w8.permute(3, 0, 1, 2).reshape(cout, k)
    return PackedWeight(w8, packed, s_w)


def plain_conv_acc(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int32 accumulators of the SAME stride-1 conv of x8 (B, H, W, Cin) by
    w8 (k, k, Cin, Cout), NHWC out; float64 is exact at these magnitudes."""
    k = w8.shape[0]
    acc = F.conv2d(x8.permute(0, 3, 1, 2).double(), w8.permute(3, 2, 0, 1).double(), padding=k // 2)
    return acc.permute(0, 2, 3, 1).round().to(torch.int32)


def int8_max_pool(x8: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max pool of (B, H, W, C) int8 (scale-preserving)."""
    B, H, W, C = x8.shape
    x = x8[:, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def plain_int8_conv(x8, s_x, w: PackedWeight, b, relu: bool = True, requant: bool = True,
                    pool: bool = False):
    """The JAX function's arithmetic in PyTorch ops: (y8, s_y), pooled after
    the quantization with `pool`, or y as bf16 without `requant`."""
    acc = plain_conv_acc(x8, w.w8)
    y = acc.float() * (s_x * w.s_w)
    if b is not None:
        y = y + b.float()
    if relu:
        y = y.clamp_min(0.0)
    if not requant:
        return y.to(torch.bfloat16)
    y8, s_y = quantize_activation(y)
    return (int8_max_pool(y8) if pool else y8), s_y


def _check_conv(x8, s_x, w: PackedWeight, b):
    if x8.dim() != 4 or x8.dtype != torch.int8:
        raise ValueError(f"int8_conv: x8 must be (B, H, W, Cin) int8, got {tuple(x8.shape)} {x8.dtype}")
    if x8.shape[-1] != w.cin:
        raise ValueError(f"int8_conv: x8 has {x8.shape[-1]} channels, the weight {w.cin}")
    if s_x.numel() != 1:
        raise ValueError("int8_conv: s_x must be one scale")
    if b is not None and tuple(b.shape) != (w.cout,):
        raise ValueError(f"int8_conv: bias {tuple(b.shape)} for {w.cout} channels")
    devices = {x8.device, s_x.device, w.packed.device} | ({b.device} if b is not None else set())
    if len(devices) != 1:
        raise ValueError(f"int8_conv: inputs on several devices {devices}")


def _conv_launch(x8, s_x, w: PackedWeight, b, relu: bool, pool: bool, absmax, acc=None):
    """The conv kernel: y f32 (pooled with `pool`) or, with `acc`, the raw
    accumulators into it."""
    B, H, W, cin = x8.shape
    x8 = x8.contiguous()
    s_x = s_x.reshape(()).float().contiguous()
    bias = None if b is None else b.float().contiguous()
    Ho, Wo = (H // 2, W // 2) if pool else (H, W)
    y = None if acc is not None else torch.empty(B, Ho, Wo, w.cout, dtype=torch.float32, device=x8.device)
    fn = _entry("gf_int8_conv", _CONV_ARGS)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x8.device):
        rc = fn(x8.data_ptr(), w.packed.data_ptr(), s_x.data_ptr(), w.s_w.data_ptr(), ptr(bias),
                ptr(y), ptr(absmax), ptr(acc), B, H, W, cin, w.ksize, w.cout, w.packed.shape[1],
                int(relu), int(pool), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv: kernel launch failed (cudaError {rc})")
    launches["int8_conv"] += 1
    return y


def _requant_launch(y, absmax):
    """The second pass: (codes int8, scale) of y with `absmax`, or bf16(y)
    when `absmax` is None."""
    fn = _entry("gf_int8_requant", _REQUANT_ARGS)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        if absmax is None:
            out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
            rc = fn(y.data_ptr(), y.numel(), None, None, None, out.data_ptr(), stream)
        else:
            q = torch.empty(y.shape, dtype=torch.int8, device=y.device)
            s = torch.empty((), dtype=torch.float32, device=y.device)
            rc = fn(y.data_ptr(), y.numel(), absmax.data_ptr(), q.data_ptr(), s.data_ptr(), None, stream)
            out = (q, s)
    if rc != 0:
        raise RuntimeError(f"int8_conv: requant launch failed (cudaError {rc})")
    launches["int8_requant"] += 1
    return out


def int8_conv(x8: torch.Tensor, s_x: torch.Tensor, w, b: torch.Tensor | None, relu: bool = True,
              requant: bool = True, pool: bool = False):
    """One quantized conv layer. x8 (B, H, W, Cin) int8, s_x its scale, w an
    HWIO float kernel or a `PackedWeight`, b (Cout,) or None. Returns (y8,
    s_y) with `requant`, y8 max-pooled 2x2 with `pool` (the scale is that of
    the layer's whole output), else y (B, H, W, Cout) bf16."""
    w = w if isinstance(w, PackedWeight) else pack_weight(w)
    _check_conv(x8, s_x, w, b)
    if pool and not requant:
        raise ValueError("int8_conv: pool needs requant (the pool is in the int8 domain)")
    if not uses_kernel(x8.device):
        return plain_int8_conv(x8, s_x, w, b, relu, requant, pool)
    if requant:
        absmax = torch.zeros(1, dtype=torch.int32, device=x8.device)
        y = _conv_launch(x8, s_x, w, b, relu, pool, absmax)
        return _requant_launch(y, absmax)
    y = _conv_launch(x8, s_x, w, b, relu, False, None)
    return _requant_launch(y, None)


def conv_accumulators(x8: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """The int32 accumulators (B, H, W, Cout) of x8 by w: the kernel's core
    alone on a CUDA tensor (for checks against the plain version), the
    plain version on the CPU."""
    _check_conv(x8, torch.zeros((), device=x8.device), w, None)
    if not uses_kernel(x8.device):
        return plain_conv_acc(x8, w.w8)
    acc = torch.empty(*x8.shape[:3], w.cout, dtype=torch.int32, device=x8.device)
    _conv_launch(x8, torch.zeros((), device=x8.device), w, None, False, False, None, acc=acc)
    return acc


def plain_int8_bmm(q0, q1, s0, s1, c: float) -> torch.Tensor:
    """f32(q0 @ q1^T) * ((s0[m] * s1[n]) * c) in f32, exact for D <= 1040."""
    if q0.shape[-1] > 1040:
        raise ValueError(f"plain_int8_bmm: D {q0.shape[-1]} > 1040 is not exact in f32")
    isim = torch.bmm(q0.float(), q1.float().transpose(1, 2))
    return isim * ((s0.float()[:, :, None] * s1.float()[:, None, :]) * c)


def _bmm_launch(q0, q1, s0, s1, c: float) -> torch.Tensor:
    B, M, D = q0.shape
    N = q1.shape[1]
    q0, q1 = q0.contiguous(), q1.contiguous()
    s0, s1 = s0.float().contiguous(), s1.float().contiguous()
    sim = torch.empty(B, M, N, dtype=torch.float32, device=q0.device)
    fn = _entry("gf_int8_bmm", _BMM_ARGS)
    with torch.cuda.device(q0.device):
        rc = fn(q0.data_ptr(), q1.data_ptr(), s0.data_ptr(), s1.data_ptr(), float(c), sim.data_ptr(),
                B, M, N, D, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_bmm: kernel launch failed (cudaError {rc})")
    launches["int8_bmm"] += 1
    return sim


def int8_bmm(q0: torch.Tensor, q1: torch.Tensor, s0: torch.Tensor, s1: torch.Tensor,
             c: float) -> torch.Tensor:
    """q0 (B, M, D), q1 (B, N, D) int8, s0 (B, M), s1 (B, N) f32, c a float
    (taken as f32) -> sim (B, M, N) f32 = f32(q0 @ q1^T) * ((s0 s1^T) * c).
    On a CUDA tensor D must be a multiple of 16. With autograd recording
    and a scale that requires a gradient, the kernel's output carries the
    plain version's gradient (through the scales; the codes have none)."""
    if q0.dim() != 3 or q1.dim() != 3 or q0.shape[0] != q1.shape[0] or q0.shape[2] != q1.shape[2]:
        raise ValueError(f"int8_bmm: q0 {tuple(q0.shape)} and q1 {tuple(q1.shape)} do not fit")
    if q0.dtype != torch.int8 or q1.dtype != torch.int8:
        raise ValueError("int8_bmm: the codes must be int8")
    if tuple(s0.shape) != tuple(q0.shape[:2]) or tuple(s1.shape) != tuple(q1.shape[:2]):
        raise ValueError(f"int8_bmm: scales {tuple(s0.shape)}, {tuple(s1.shape)} do not fit the codes")
    c = float(np.float32(c))
    if not uses_kernel(q0.device):
        return plain_int8_bmm(q0, q1, s0, s1, c)
    if q0.shape[2] % 16:
        raise ValueError(f"int8_bmm: the kernel takes D a multiple of 16, got {q0.shape[2]}")
    if needs_grad(s0, s1):
        return kernel_with_plain_grad(_bmm_launch, plain_int8_bmm, q0, q1, s0, s1, c)
    return _bmm_launch(q0, q1, s0, s1, c)


def dense_pass_work(batch: int, height: int, width: int, channels, head: int, desc: int) -> dict:
    """Operations (2 a multiply-add) and bytes (int8 in and out once a layer,
    the packed weights once, the heads' bf16 outputs) of SuperPoint's int8
    dense pass, layer by layer: what bounds `int8_conv` on the card."""
    layers = []
    h, w, cin = height, width, 1
    for i, c in enumerate(channels):
        for tag in "ab":
            pool = tag == "b" and i < len(channels) - 1
            out_hw = (h // 2) * (w // 2) if pool else h * w
            layers.append((f"conv{i+1}{tag}", h * w, cin, c, 3, out_hw, 1))
            cin = c
        if i < len(channels) - 1:
            h, w = h // 2, w // 2
    for name, c_mid, c_out in (("P", head, 65), ("D", head, desc)):
        layers.append((f"conv{name}a", h * w, cin, c_mid, 3, h * w, 1))
        layers.append((f"conv{name}b", h * w, c_mid, c_out, 1, h * w, 2))
    out = {}
    for name, pixels, ci, co, k, out_pixels, out_bytes in layers:
        ops = 2 * batch * pixels * k * k * ci * co
        n_bytes = batch * pixels * ci + batch * out_pixels * co * out_bytes + k * k * ci * co
        out[name] = {"ops": ops, "bytes": n_bytes}
    return out
