"""SuperPoint's fused decode kernel: the wrapper of the hand-written CUDA
kernel `csrc/nms_tile_reduce.cu`, its plain PyTorch version, and
`detect_keypoints` on top (counterpart of `gluefactory_tpu/ops/pallas_detect.py`).

`fused_nms_tile_reduce` replaces `pallas_detect.py::fused_nms_tile_reduce`:
iterated NMS, border removal, the true-image-area mask and the max and
argmax of every tile in one pass. Tie rule within a tile (that of the TPU
kernel): the smallest dx among maximal columns, then the smallest dy in that
column. The non-fused path (`ops/nms.py`) breaks such ties otherwise; the two
differ only on a tile with two equal survivors, which carry the same score.

Dispatch is by device alone: a CUDA tensor goes to the kernel, which is
built at first use (`_build.py`) and raises if it does not build or launch;
a CPU tensor goes to `nms_tile_reduce_plain`. `detect_kernel_available`
states what the kernel takes. The decode has no gradient, as the JAX kernel
has none (`jax.grad` through it raises): with autograd recording scores
that require a gradient, `fused_nms_tile_reduce` raises on every device
rather than return outputs that silently drop it. `launches` counts kernel
launches so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import uses_kernel
from .nms import _top_k, mask_outside, remove_borders, simple_nms

launches = {"fused_nms_tile_reduce": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# a block of the kernel covers 32 x 64 pixels, so the tile must divide 32;
# the kernel is compiled for radii 0-6 (at 2 iterations radius 7 would not
# fit in a block's shared memory)
_REGION_ROWS, _REGION_COLS = 32, 64
_MAX_RADIUS = 6


def reset_launches() -> None:
    launches["fused_nms_tile_reduce"] = 0


def shared_bytes(radius: int, iters: int) -> int:
    """Shared memory of one block of the kernel: its region with a halo of
    (2 iters + 1) r pixels, an odd row stride, four f32 buffers and one byte
    mask per pixel."""
    h = (2 * iters + 1) * radius
    return (_REGION_ROWS + 2 * h) * ((_REGION_COLS + 2 * h) | 1) * 17


def detect_kernel_available(H: int, W: int, radius: int, iters: int = 2, tile: int = 4) -> bool:
    """Whether the CUDA kernel takes this decode: a tile that divides the
    block's 32 rows, H and W, a radius in [0, 6], and a halo that fits a
    block's shared memory (`shared_bytes`). The TPU kernel's VMEM chunking
    (`_pick_chunk`) does not apply."""
    return (H > 0 and W > 0 and tile >= 1 and _REGION_ROWS % tile == 0 and H % tile == 0
            and W % tile == 0 and 0 <= radius <= _MAX_RADIUS and iters >= 0
            and shared_bytes(radius, iters) <= _build.MAX_SHARED_BYTES)


def _true_size(true_size, B: int, H: int, W: int, device) -> torch.Tensor:
    if true_size is None:
        return torch.tensor([[float(W), float(H)]] * B, dtype=torch.float32, device=device)
    return true_size.to(device=device, dtype=torch.float32).contiguous()


def nms_tile_reduce_plain(scores, true_size=None, radius: int = 4, iters: int = 2,
                          border: int = 4, tile: int = 4):
    """The composition of `ops/nms.py` the kernel fuses (`nms_tile_reduce_xla`
    of the JAX package) with the kernel's tie rule: scores (B,H,W) ->
    (tile_max (B,H/t,W/t) f32, tile_arg (B,H/t,W/t) i32 = dy * t + dx)."""
    B, H, W = scores.shape
    s = remove_borders(simple_nms(scores.float(), radius, iters), border)
    if true_size is not None:
        s = mask_outside(s, true_size, border)
    Ht, Wt = H // tile, W // tile
    # (B, Ht, Wt, dx, dy): the first maximum in this order is the tie rule
    blocks = s.reshape(B, Ht, tile, Wt, tile).permute(0, 1, 3, 4, 2).reshape(B, Ht, Wt, tile * tile)
    tile_max, k = blocks.max(dim=-1)
    tile_arg = (k % tile) * tile + k // tile
    return tile_max, tile_arg.to(torch.int32)


def fused_nms_tile_reduce(scores, true_size=None, radius: int = 4, iters: int = 2,
                          border: int = 4, tile: int = 4):
    """scores (B,H,W) f32 or bf16, true_size (B,2) [w,h] or None (the whole
    buffer) -> (tile_max (B,H/t,W/t) f32, tile_arg (B,H/t,W/t) i32 in
    [0, t*t), dy * t + dx). CUDA tensors run csrc/nms_tile_reduce.cu; CPU
    tensors `nms_tile_reduce_plain`. Not differentiable: raises under
    autograd with scores that require a gradient."""
    if torch.is_grad_enabled() and scores.requires_grad:
        raise RuntimeError("fused_nms_tile_reduce has no gradient (nor has the JAX kernel it "
                           "replaces): call it under torch.no_grad() or on detached scores")
    if not uses_kernel(scores.device):
        return nms_tile_reduce_plain(scores, true_size, radius, iters, border, tile)
    if scores.dim() != 3:
        raise ValueError(f"fused_nms_tile_reduce: scores must be (B, H, W), got {tuple(scores.shape)}")
    if scores.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_nms_tile_reduce: dtype {scores.dtype} not supported (float32, bfloat16)")
    B, H, W = scores.shape
    if tile < 1 or _REGION_ROWS % tile or H % tile or W % tile:
        raise ValueError(f"fused_nms_tile_reduce: tile {tile} must divide {_REGION_ROWS}, H {H} and W {W}")
    if not 0 <= radius <= _MAX_RADIUS or iters < 0:
        raise ValueError(f"fused_nms_tile_reduce: radius {radius} must be in [0, {_MAX_RADIUS}] "
                         f"and iters {iters} >= 0")
    if shared_bytes(radius, iters) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"fused_nms_tile_reduce: radius {radius} with {iters} iterations needs "
                         f"{shared_bytes(radius, iters)} bytes of shared memory per block, "
                         f"over the {_build.MAX_SHARED_BYTES} a block may have")
    ts = _true_size(true_size, B, H, W, scores.device)
    if tuple(ts.shape) != (B, 2):
        raise ValueError(f"fused_nms_tile_reduce: true_size of shape {tuple(ts.shape)}, expected {(B, 2)}")
    scores = scores.contiguous()
    tile_max = torch.empty(B, H // tile, W // tile, dtype=torch.float32, device=scores.device)
    tile_arg = torch.empty(B, H // tile, W // tile, dtype=torch.int32, device=scores.device)
    if tile_max.numel() == 0:
        return tile_max, tile_arg
    fn = _build.function("fused_nms_tile_reduce", _ARGTYPES)
    with torch.cuda.device(scores.device):
        rc = fn(scores.data_ptr(), ts.data_ptr(), tile_max.data_ptr(), tile_arg.data_ptr(),
                B, H, W, radius, iters, border, tile, _DTYPE_CODES[scores.dtype],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_nms_tile_reduce: kernel launch failed (cudaError {rc})")
    launches["fused_nms_tile_reduce"] += 1
    return tile_max, tile_arg


def detect_keypoints(scores, k: int, threshold: float, radius: int = 4, iters: int = 2,
                     border: int = 4, true_size=None):
    """Full decode: `fused_nms_tile_reduce` (tile 4), top-k over the tile
    maxima (equal values in index order), coordinates. Exact for radius >= 3:
    NMS survivors are more than r apart, so a 4x4 tile holds at most one
    distinct survivor. Returns (keypoints (B,k,2) xy with the COLMAP +0.5
    offset, scores (B,k) in the input dtype, valid (B,k))."""
    tile = 4
    B, H, W = scores.shape
    tmax, targ = fused_nms_tile_reduce(scores, true_size, radius, iters, border, tile)
    Wt = W // tile
    vals, tidx = _top_k(tmax.reshape(B, -1), k)
    vals = vals.to(scores.dtype)  # the threshold applies in the input dtype
    inner = targ.reshape(B, -1).gather(1, tidx)
    xs = (tidx % Wt * tile + inner % tile).float()
    ys = (tidx // Wt * tile + inner // tile).float()
    kpts = torch.stack([xs, ys], dim=-1) + 0.5
    valid = vals > torch.tensor(threshold, dtype=vals.dtype, device=vals.device)
    return kpts, vals, valid
