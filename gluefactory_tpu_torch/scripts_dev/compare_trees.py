"""Time SuperGlue's Sinkhorn kernel, SuperPoint's four VGG blocks, its
fused decode and both attention kernels in f32 as two or more checkouts of
the port compute them, in turns on one card.

    python gluefactory_tpu_torch/scripts_dev/compare_trees.py TREE [TREE ...]

Each TREE is the root of a checkout (a `git archive` of another commit,
unpacked into `build/`, or this one). Each run is a subprocess whose
`sys.path` starts at its tree, so it imports that tree's
`gluefactory_tpu_torch` and builds that tree's kernels; every run draws its
inputs from the same seeds. Give the trees in the order to run them, for
example A B B A. Prints one JSON line per run, and last a line with every
run's times, the card's name and power limit.

Shapes are the paths' own: Sinkhorn at (4, 2049, 2049), 50 iterations, f32
(path B); the VGG blocks of path C, 8 images bf16 (conv1b + pool at 1024^2
x 64, blocks 2-4); the decode at path C's score maps, 8 x 1024^2 bf16,
radius 4, with the true size given as path C gives it; the attention
kernels at path E's shapes, f32, every token valid: `fused_attention` at
(64, 4, 512, 64) (both views' self-attention) and
`fused_bidirectional_attention` at (32, 4, 512, 64), each beside SDPA on the
same inputs (both directions stacked for the cross-attention). The VGG
blocks, the decode and the attention by device time (`device_time_ms`: the calls queued behind a
sleep kernel, so the wrapper's Python between launches does not count);
Sinkhorn by CUDA events around the calls as the
host issues them (`cuda_time_ms`: ten calls of a design that launches a
row and a column pass a kernel each per iteration overflow the launch
queue, so they cannot all be queued behind the sleep).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

# path E: batch 32, 4 heads of 64, 512 keypoints; self-attention runs both
# views stacked
ATTENTION_F32 = [("fused_attention", 64), ("fused_bidirectional_attention", 32)]
ATTENTION_HEADS, ATTENTION_TOKENS, ATTENTION_DIM = 4, 512, 64

VGG_BLOCKS = [
    ("conv1b_pool", (8, 1024, 1024, 64), 64, None, True),
    ("block2", (8, 512, 512, 64), 64, 64, True),
    ("block3", (8, 256, 256, 64), 128, 128, True),
    ("block4", (8, 128, 128, 128), 128, 128, False),
]


def worker(tree: str) -> dict:
    """The timings of one tree's kernels (run in a process of its own)."""
    sys.path.insert(0, tree)
    import torch

    from gluefactory_tpu_torch.ops import cuda_attention, cuda_conv, cuda_detect, cuda_sinkhorn
    from gluefactory_tpu_torch.scripts_dev.timing import card, cuda_time_ms, device_time_ms

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 as path E runs it
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    B, M, iters = 4, 2049, 50
    Z = torch.randn(B, M, M, generator=gen, device=dev)
    mu = torch.full((B, M), -math.log(2 * M), device=dev)
    sinkhorn = lambda: cuda_sinkhorn.log_sinkhorn(Z, mu, mu, iters)  # noqa: E731
    res = {"tree": tree, "card": card(dev), "log_sinkhorn": {"event_ms": cuda_time_ms(sinkhorn, reps=10)}}
    del Z
    for name, shape, cm, co, pool in VGG_BLOCKS:
        ci = shape[-1]
        x = torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(torch.bfloat16)
        w = [torch.randn(3, 3, ci, cm, generator=gen, device=dev) * math.sqrt(2.0 / (9 * ci)),
             torch.randn(cm, generator=gen, device=dev) * 0.1]
        if co is not None:
            w += [torch.randn(3, 3, cm, co, generator=gen, device=dev) * math.sqrt(2.0 / (9 * cm)),
                  torch.randn(co, generator=gen, device=dev) * 0.1]
        w = [a.to(torch.bfloat16) for a in w]
        block = lambda: cuda_conv.fused_vgg_block(x, *w, pool=pool)  # noqa: E731
        res[name] = {"device_ms": device_time_ms(block, reps=10)}
        del x, w
    res["vgg_total_device_ms"] = sum(res[b[0]]["device_ms"] for b in VGG_BLOCKS)
    s = (torch.rand(8, 1024, 1024, generator=gen, device=dev) * 0.99 + 0.01).to(torch.bfloat16)
    full = torch.full((8, 2), 1024.0, device=dev)
    decode = lambda: cuda_detect.fused_nms_tile_reduce(s, full, radius=4)  # noqa: E731
    res["fused_nms_tile_reduce"] = {"device_ms": device_time_ms(decode, reps=20)}
    del s
    H, N, D = ATTENTION_HEADS, ATTENTION_TOKENS, ATTENTION_DIM
    F = torch.nn.functional
    for name, B in ATTENTION_F32:
        xs = [torch.randn(B, H, N, D, generator=gen, device=dev) for _ in range(3 if name == "fused_attention" else 4)]
        ones = torch.ones(B, N, dtype=torch.bool, device=dev)
        kernel = getattr(cuda_attention, name)
        if len(xs) == 3:
            lib_in = xs
        else:
            qk0, qk1, v0, v1 = xs
            lib_in = [torch.cat([qk0, qk1]), torch.cat([qk1, qk0]), torch.cat([v1, v0])]
        fn = lambda: kernel(*xs, ones, ones)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(*lib_in)  # noqa: E731
        res[f"{name}_f32"] = {"shape": [B, H, N, D], "device_ms": device_time_ms(fn, reps=20),
                              "sdpa_ms": device_time_ms(sdpa, reps=20)}
        del xs, lib_in
    return res


def main(trees: list[str]) -> list[dict]:
    runs = []
    for tree in trees:
        root = str(Path(tree).resolve())
        proc = subprocess.run([sys.executable, __file__, "--worker", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"compare_trees: the run of {root} failed:\n{proc.stderr[-4000:]}")
        out = proc.stdout.strip().splitlines()[-1]
        runs.append(json.loads(out))
        print(out, flush=True)
    print(json.dumps({"runs": runs}))
    return runs


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
