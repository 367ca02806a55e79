"""Where a kernel's time goes, by subtraction: build variants of its source
that each leave one phase out (or change one thing), and time every variant
against the kernel as it is, in one process on one card.

    python -m gluefactory_tpu_torch.scripts_dev.kernel_variants [sinkhorn|vgg|detect|attention ...]

A variant is a copy of `csrc/` with text substitutions in it, built by nvcc
with the port's flags into `build/torch_ext/variants/` and called through
the kernel's own wrapper. A variant that leaves a phase out computes wrong
results: only its time means something. Prints one JSON line per kernel
(ms of the kernel and of each variant, in turns kernel, variants, kernel),
with the card's name and power limit.

- sinkhorn: `log_sinkhorn` at path B's shape (4, 2049, 2049), 50
  iterations, without the grid barriers, the merge, the row step, the
  column step, or the shifted single passes, and with cooperative_groups'
  grid sync in place of its arrive counter;
- vgg: `fused_vgg_block` at conv1b + pool (8, 1024^2, 64) bf16, and the
  same conv without the pool, against the bare N-packed conv
  (`npack_conv3x3`), with the epilogue's ReLU, bias or x-pool shuffle left
  out;
- detect: `fused_nms_tile_reduce` at path C's score maps (8, 1024^2) bf16,
  radius 4, without the load into shared memory, the float pools (both
  passes of all three), or the tile reduction;
- attention: `fused_attention`'s f32 body at path E's shape (64, 4, 512,
  64), every token valid, without the S = QK^T products, the PV products,
  or the exponentials, and at one block an SM (registers unbounded) in
  place of two.
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import subprocess
import sys

import torch

from ..ops import _build, cuda_attention, cuda_conv, cuda_conv3x3, cuda_detect, cuda_sinkhorn
from .timing import card, cuda_time_ms, device_time_ms

VARIANT_DIR = _build.BUILD_DIR / "variants"

# name -> (source, [(text, replacement), ...])
VARIANTS = {
    "sinkhorn": {
        "no_barrier": ("log_sinkhorn.cu", [("grid_barrier(p.counter, target);", "__syncthreads();")]),
        "grid_sync": ("log_sinkhorn.cu", [("#include <cuda_runtime.h>",
                                           "#include <cooperative_groups.h>\n#include <cuda_runtime.h>"),
                                          ("grid_barrier(p.counter, target);",
                                           "cooperative_groups::this_grid().sync();")]),
        "no_merge": ("log_sinkhorn.cu", [("for (int cc = c0; cc < c1; cc += kMergeCols) {",
                                          "for (int cc = c0; cc < c0; cc += kMergeCols) {")]),
        "no_row_step": ("log_sinkhorn.cu", [("for (int i = warp; i < nrows; i += kWarps) {",
                                             "for (int i = warp; i < 0; i += kWarps) {")]),
        "no_column_step": ("log_sinkhorn.cu", [("for (int j = tid; j < N; j += kThreads) {\n          float mg",
                                                "for (int j = tid; j < 0; j += kThreads) {\n          float mg")]),
        "no_shift": ("log_sinkhorn.cu", [("if (it > 0 && shift > kMaxFloor && shift < INFINITY) {",
                                          "if (false) {"),
                                         ("if (kVShared && it > 0 && shift > kMaxFloor && shift < INFINITY) {",
                                          "if (false) {"),
                                         ("if (it > 0 && mg > kMaxFloor && mg < INFINITY) {",
                                          "if (false) {")]),
    },
    "vgg": {
        "no_relu": ("vgg_block.cu", [("return pack_bf16_relu(lo + bias[2 * i], hi + bias[2 * i + 1]);",
                                      "return pack_bf16(lo, hi);")]),
        "no_bias": ("vgg_block.cu", [("return pack_bf16_relu(lo + bias[2 * i], hi + bias[2 * i + 1]);",
                                      "return pack_bf16_relu(lo, hi);")]),
        "no_shuffle": ("vgg_block.cu", [("v = max_bf16x2(v, __shfl_xor_sync(0xffffffffu, v, 4));", "")]),
    },
    "detect": {
        "no_load": ("nms_tile_reduce.cu", [("  load_region<R, T>(scores", "  if (false) load_region<R, T>(scores")]),
        "no_float_pools": ("nms_tile_reduce.cu", [("  pool_rows<R, false>(p);", ""),
                                                  ("  pool_columns_compare<R, false>(p);", ""),
                                                  ("    pool_rows<R, true>(p);", ""),
                                                  ("    pool_columns_compare<R, true>(p);", "")]),
        "no_tile_reduce": ("nms_tile_reduce.cu", [("t < (kOutRows / tile) * halves;", "t < 0;")]),
    },
    "attention": {
        "no_s": ("fused_attention.cu", [("for (int c = 0; c < D / 4; ++c) {\n      const int cq",
                                         "for (int c = 0; c < 0; ++c) {\n      const int cq")]),
        "no_pv": ("fused_attention.cu", [("for (int c = 0; c < kF32Keys / 4; ++c) {\n      const int cp",
                                          "for (int c = 0; c < 0; ++c) {\n      const int cp")]),
        "no_exp": ("fused_attention.cu", [("sm90::ex2(fmaf(s[i][j], sl2, -ms))",
                                           "fmaf(s[i][j], sl2, -ms)")]),
        "one_block_an_sm": ("fused_attention.cu", [("__launch_bounds__(kF32Threads, 2)",
                                                    "__launch_bounds__(kF32Threads, 1)")]),
    },
}
KERNEL_OF = {"sinkhorn": "log_sinkhorn", "vgg": "fused_vgg_block", "detect": "fused_nms_tile_reduce",
             "attention": "fused_attention"}


def build_variants(kernel: str) -> dict[str, ctypes.CDLL]:
    """Each variant of `kernel` built in parallel; raises if a substitution
    finds nothing or a build fails."""
    procs = {}
    for name, (source, subs) in VARIANTS[kernel].items():
        d = VARIANT_DIR / kernel / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for text, replacement in subs:
            hits = [f for f in d.iterdir() if text in f.read_text()]
            if not hits:
                raise ValueError(f"variant {kernel}/{name}: {text!r} not found in csrc/")
            for f in hits:
                f.write_text(f.read_text().replace(text, replacement))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {kernel}/{name} failed to build:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(VARIANT_DIR / kernel / name / "lib.so"))
    return libs


def with_library(kernel: str, lib: ctypes.CDLL, fn):
    """fn() with the kernel's wrapper calling `lib` instead of the build."""
    name = KERNEL_OF[kernel]
    real = _build.function

    def function(n, argtypes):
        if n != name:
            return real(n, argtypes)
        f = getattr(lib, "gf_" + n)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f

    _build.function = function
    try:
        return fn()
    finally:
        _build.function = real


def _timed(kernel: str, libs: dict, runs: dict, timer=cuda_time_ms) -> dict:
    """{run: ms} for each run of `runs` (name -> call) with the kernel as it
    is, then with every variant, then the kernel again."""
    out = {}
    for run, call in runs.items():
        out[f"{run}/kernel"] = [timer(call, reps=10)]
        for name, lib in libs.items():
            out[f"{run}/{name}"] = with_library(kernel, lib, lambda: timer(call, reps=10))
        out[f"{run}/kernel"].append(timer(call, reps=10))
    return out


def main(kernels=("sinkhorn", "vgg", "detect", "attention")) -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _build.build_all([KERNEL_OF[k] for k in kernels] + ["npack_conv3x3"])
    results = []
    for kernel in kernels:
        libs = build_variants(kernel)
        if kernel == "sinkhorn":
            B, M, iters = 4, 2049, 50
            Z = torch.randn(B, M, M, generator=gen, device=dev)
            mu = torch.full((B, M), -math.log(2 * M), device=dev)
            runs = {"path_b": lambda: cuda_sinkhorn.log_sinkhorn(Z, mu, mu, iters)}
            shape = [B, M, M, iters]
        elif kernel == "detect":
            # device time: the decode is short beside its wrapper's host time
            s = (torch.rand(8, 1024, 1024, generator=gen, device=dev) * 0.99 + 0.01).to(torch.bfloat16)
            full = torch.full((8, 2), 1024.0, device=dev)
            runs = {"path_c": lambda: cuda_detect.fused_nms_tile_reduce(s, full)}
            shape = [8, 1024, 1024]
        elif kernel == "attention":
            shape = [64, 4, 512, 64]
            q, k, v = (torch.randn(*shape, generator=gen, device=dev) for _ in range(3))
            ones = torch.ones(shape[0], shape[2], dtype=torch.bool, device=dev)
            runs = {"path_e_f32": lambda: cuda_attention.fused_attention(q, k, v, ones, ones)}
        else:
            x = torch.relu(torch.randn(8, 1024, 1024, 64, generator=gen, device=dev)).to(torch.bfloat16)
            w = (torch.randn(3, 3, 64, 64, generator=gen, device=dev) * 0.06).to(torch.bfloat16)
            b = (torch.randn(64, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
            runs = {"conv1b_pool": lambda: cuda_conv.fused_vgg_block(x, w, b, pool=True),
                    "conv1b_no_pool": lambda: cuda_conv.fused_vgg_block(x, w, b, pool=False)}
            shape = [8, 1024, 1024, 64]
        ms = _timed(kernel, libs, runs, device_time_ms if kernel in ("detect", "attention") else cuda_time_ms)
        if kernel == "vgg":
            ms["bare_npack_conv3x3"] = cuda_time_ms(lambda: cuda_conv3x3.npack_conv3x3(x, w), reps=10)
        res = {"kernel": KERNEL_OF[kernel], "shape": shape, "ms": ms, "card": card(dev)}
        results.append(res)
        print(json.dumps(res), flush=True)
    return results


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("sinkhorn", "vgg", "detect", "attention"))
