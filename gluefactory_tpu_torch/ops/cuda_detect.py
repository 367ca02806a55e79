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
states what the kernel takes; `fused_detect_available`, the JAX package's
routing predicate, where SuperPoint takes the fused decode. The decode has
no gradient, as the JAX kernel has none (`jax.grad` through it raises):
with autograd recording scores that require a gradient,
`fused_nms_tile_reduce` raises on every device rather than return outputs
that silently drop it. `launches` counts kernel
launches so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import uses_kernel
from .nms import _top_k, mask_outside, remove_borders, simple_nms

launches = {"fused_nms_tile_reduce": 0}

# Test hook, the counterpart of `pallas_detect.FORCE_INTERPRET`: lets
# SuperPoint's `fused_detect` gate take the fused decode (its plain version)
# on a CPU tensor.
FORCE_FUSED = False

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# a block of the kernel owns 64 x 64 output pixels with a halo of 5r (up to
# 2 iterations); the kernel is compiled for radii 0-8
_OUT_ROWS = _OUT_COLS = 64
_MAX_RADIUS = 8
_MAX_ITERS = 2
_SHARED_PER_SM = 233472  # bytes of shared memory on an H100 SM
_RESERVED_PER_BLOCK = 1024


def reset_launches() -> None:
    launches["fused_nms_tile_reduce"] = 0


def detect_plan(radius: int) -> dict:
    """The kernel's block at `radius` (mirrors `Geometry` in
    csrc/nms_tile_reduce.cu): the haloed region, its f32 row stride and mask
    words a row, the shared memory of a block (scores and row-pass scratch
    in f32, two bit planes), the blocks an SM takes, and the halo's cost
    (region pixels over output pixels)."""
    h = (2 * _MAX_ITERS + 1) * radius
    rows, cols = _OUT_ROWS + 2 * h, _OUT_COLS + 2 * h
    ld, words = cols | 1, ((cols + 31) // 32) | 1
    smem = (2 * rows * ld + 2 * rows * words) * 4
    return {"region": (rows, cols), "shared_bytes": smem,
            "blocks_per_sm": 2 if 2 * (smem + _RESERVED_PER_BLOCK) <= _SHARED_PER_SM else 1,
            "halo_overhead": rows * cols / (_OUT_ROWS * _OUT_COLS)}


def _tile_taken(tile: int) -> bool:
    """A power of two up to 32: it divides the block's 64 columns, and a
    tile's columns share a warp."""
    return 1 <= tile <= 32 and tile & (tile - 1) == 0


def detect_kernel_available(H: int, W: int, radius: int, iters: int = 2, tile: int = 4) -> bool:
    """Whether the CUDA kernel takes this decode: a tile that `_tile_taken`
    and that divides H and W, a radius in [0, 8] and at most 2 iterations
    (the halo the kernel is compiled for). This is the kernel's limit, not
    where SuperPoint takes the fused decode (`fused_detect_available`)."""
    return (H > 0 and W > 0 and _tile_taken(tile) and H % tile == 0 and W % tile == 0
            and 0 <= radius <= _MAX_RADIUS and 0 <= iters <= _MAX_ITERS)


def _pick_chunk(H: int, tile: int, target: int = 256) -> int:
    """Largest divisor of H that is <= target and a multiple of tile (the
    TPU kernel's row chunk, `pallas_detect.py::_pick_chunk`)."""
    best = 0
    for c in range(tile, min(target, H) + 1, tile):
        if H % c == 0:
            best = c
    return best


def fused_detect_available(H: int, W: int, tile: int = 4) -> bool:
    """The JAX package's routing predicate for the fused decode
    (`pallas_detect.py::fused_detect_available`): a row chunk of the TPU
    kernel that divides H, is a multiple of the tile and lies in [32, 256].
    It decides where SuperPoint takes the fused decode, so that both
    packages pick the same keypoints; it is not the CUDA kernel's limit
    (`detect_kernel_available`)."""
    return W % tile == 0 and _pick_chunk(H, tile) >= 8 * tile


def _true_size(true_size, B: int, H: int, W: int, device) -> torch.Tensor:
    if true_size is None:
        # filled on the device: a copy from host memory would wait for the
        # device, and the host could not queue calls ahead of it
        ts = torch.full((B, 2), float(W), dtype=torch.float32, device=device)
        ts[:, 1] = float(H)
        return ts
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
    if not _tile_taken(tile) or H % tile or W % tile:
        raise ValueError(f"fused_nms_tile_reduce: tile {tile} must be a power of two up to 32 "
                         f"that divides H {H} and W {W}")
    if not 0 <= radius <= _MAX_RADIUS or not 0 <= iters <= _MAX_ITERS:
        raise ValueError(f"fused_nms_tile_reduce: the kernel takes radii 0 to {_MAX_RADIUS} and "
                         f"0 to {_MAX_ITERS} iterations, got radius {radius}, iters {iters}")
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
