"""Benchmark of the PyTorch/CUDA port: SuperPoint + LightGlue two-view
inference throughput on one NVIDIA GPU (the port's counterpart of bench.py).

    python3 bench_torch.py

Prints ONE JSON line with bench.py's keys: `metric`, `value` (pairs/s),
`unit`, `vs_baseline` (bench.py's A100 anchor, 36 pairs/s, from the
LightGlue paper's RTX 3080 figure), `gflops_per_pair`, `mfu` (against the
H100 SXM's dense bf16 peak, 989 TFLOP/s), `pruned` (the early-exit serving
path at the published serving defaults, exits forced as bench.py forces
them, with its 3/5/7/9-layer sweep), `device` (the card's name and power
limit from nvidia-smi), and two keys of the port's own: `graphed`, the
same dense forward captured once in a CUDA graph and replayed, and
`graphed_matcher`, LightGlue alone on the extracted features, eager and
replayed. Where a capture fails, its key holds the error and the port's
line that raised it.

Same model configuration, sizes and inputs as bench.py: `BENCH_BATCH`
pairs (4) of `BENCH_IMAGE_SIZE`² (1024) random images from
`np.random.default_rng(0)`, `BENCH_KEYPOINTS` (2048) keypoints,
LightGlue-9, random weights (from seeds), bf16.

Method: CUDA events around `BENCH_ITERS` (50) forwards issued by the host
after a warm-up, three repeats; `value` is the median, `spread` the
repeats' range. Eager forwards include the host's launch time between
kernels, which bench.py's single XLA program does not pay; `graphed`
replays the captured forward, the port's counterpart of that program.

`BENCH_QUANTIZE=int8` runs SuperPoint's dense pass in int8 and
`BENCH_INT8_SIM=1` LightGlue's similarity in int8, as bench.py reads them
(both through `csrc/int8_conv.cu`; the pruned run's matcher keeps its float
similarity, as bench.py's). `gflops_per_pair` and `mfu` then count the
int8 products too (by hand: the kernels are launched through ctypes), still
against the bf16 peak.

`main(device="cpu", ...)` runs every path once at a given size with the
times null (the tests do); a CPU run has no device time.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.matchers.lightglue_serving import make_serving_fn
from gluefactory_tpu_torch.ops import _build
from gluefactory_tpu_torch.ops.int8_conv import dense_pass_work
from gluefactory_tpu_torch.scripts_dev.timing import card

ROOT = Path(__file__).resolve().parent
A100_BASELINE_PAIRS_PER_SEC = 36.0
H100_BF16_PEAK_FLOPS = 989e12

BATCH = int(os.environ.get("BENCH_BATCH", "4"))
IMAGE_SIZE = int(os.environ.get("BENCH_IMAGE_SIZE", "1024"))
NUM_KEYPOINTS = int(os.environ.get("BENCH_KEYPOINTS", "2048"))
ITERS = int(os.environ.get("BENCH_ITERS", "50"))
EXIT_LAYERS = int(os.environ.get("BENCH_EXIT_LAYERS", "5"))
QUANTIZE = os.environ.get("BENCH_QUANTIZE", "none")
INT8_SIM = os.environ.get("BENCH_INT8_SIM", "0")

N_LAYERS = 9
REPEATS = 3
WARMUP = 3
SWEEP = (3, 5, 7, 9)
# graphed against eager where bit equality fails: chip_smoke.py's bf16 gate
# for kernel outputs
BF16_GATE = 2e-2


def pipeline_conf(keypoints: int, quantize: str = "none", int8_sim: str = "0") -> dict:
    return {
        "extractor": {"name": "superpoint", "max_num_keypoints": keypoints,
                      "detection_threshold": 0.0, "force_num_keypoints": True,
                      "trainable": False, "quantize": None if quantize == "none" else quantize},
        "matcher": {"name": "lightglue", "n_layers": N_LAYERS, "checkpointed": False,
                    "int8_similarity": int8_sim == "1"},
    }


def int8_ops(batch: int, image_size: int, keypoints: int, model) -> float:
    """The int8 kernels' products a forward: SuperPoint's dense pass on 2B
    images (`quantize`), LightGlue's last similarity (`int8_similarity`)."""
    ops = 0.0
    sp, lg = model.extractor.conf, model.matcher.conf
    if sp.quantize == "int8":
        work = dense_pass_work(2 * batch, image_size, image_size, sp.channels, sp.head_channels,
                               sp.descriptor_dim)
        ops += sum(w["ops"] for w in work.values())
    if lg.int8_similarity:
        ops += 2.0 * batch * keypoints * keypoints * lg.descriptor_dim
    return ops


def make_batch(device, batch: int, size: int) -> dict:
    """bench.py's inputs: view 0's images, then view 1's, from rng(0)."""
    rng = np.random.default_rng(0)
    image_size = torch.tensor([[float(size), float(size)]] * batch, device=device)
    views = {}
    for v in ("view0", "view1"):
        img = rng.uniform(0, 1, (batch, size, size, 1)).astype(np.float32)
        views[v] = {"image": torch.from_numpy(img).to(device, torch.bfloat16),
                    "image_size": image_size}
    return views


def time_forward(forward, iters: int, device) -> list | None:
    """Milliseconds per forward of REPEATS runs of `iters` forwards between
    two CUDA events, after WARMUP forwards; on the CPU one forward and None."""
    if device.type != "cuda":
        forward()
        return None
    for _ in range(WARMUP):
        forward()
    out = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            forward()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def rate(ms: list | None, batch: int) -> dict:
    """pairs/s of the median repeat, and the repeats' range."""
    if ms is None:
        return {"pairs_per_sec": None, "ms_per_forward": None, "spread": None, "repeats_ms": None}
    pps = sorted(batch * 1e3 / m for m in ms)
    return {"pairs_per_sec": statistics.median(pps), "ms_per_forward": statistics.median(ms),
            "spread": [pps[0], pps[-1]], "repeats_ms": ms}


def attention_flops(batch: int, keypoints: int, conf) -> float:
    """The attention kernels' products per forward, which FlopCounterMode
    cannot see (they are launched through ctypes): 4·B·H·M·N·D per
    self-attention call (QK^T and PV; both views stacked, so B = 2 pairs),
    6·B·H·M·N·D per bidirectional call (the similarity once, two PV)."""
    heads, dim = conf.num_heads, conf.descriptor_dim // conf.num_heads
    per_pair = keypoints * keypoints * heads * dim
    return conf.n_layers * (4.0 * 2 * batch + 6.0 * batch) * per_pair


def count_flops(forward) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        forward()
    return float(counter.get_total_flops())


def forced_exit(matcher, exit_layers: int) -> None:
    """bench.py's `forced_exit_params`: token-confidence kernels zero, biases
    +20 from layer `exit_layers - 1` on and -20 before, so every item exits
    after `exit_layers` layers."""
    with torch.no_grad():
        for i, head in enumerate(matcher.token_confidence):
            head.token[0].weight.zero_()
            head.token[0].bias.fill_(20.0 if i >= exit_layers - 1 else -20.0)


def extractor_pipeline(model, device):
    """A two-view pipeline without a matcher that shares `model.extractor`:
    the suffixed features of both views, as the serving path takes them."""
    extract = get_model("two_view_pipeline").from_conf({"extractor": {"name": None}}, device=device)
    extract.extractor = model.extractor
    return extract


def bench_pruned(model, batch, device, batch_size: int, iters: int, exit_layers: int) -> dict:
    """The early-exit serving path (`make_serving_fn`) at the official
    serving defaults, depth_confidence 0.95 and width_confidence 0.99, on a
    LightGlue of its own (random weights, seed 3, as bench.py inits its
    serving matcher apart) after the main model's extractor. Random weights
    on random images never exit, so the heads are biased to exit after
    `exit_layers` layers; the sweep repeats that at 3, 5, 7 and 9 layers."""
    torch.manual_seed(3)
    lg = get_model("lightglue").from_conf(
        {"n_layers": N_LAYERS, "checkpointed": False, "flash": True,
         "depth_confidence": 0.95, "width_confidence": 0.99}, device=device)
    lg = lg.to(torch.bfloat16).eval()
    serving = make_serving_fn(lg)
    extract = extractor_pipeline(model, device)
    gen = torch.Generator(device=device)
    last = {}

    def forward():
        feats = extract(batch, generator=gen.manual_seed(0))
        last["pred"] = serving({**batch, **feats})

    def measure(k):
        forced_exit(lg, k)
        ms = time_forward(forward, iters, device)
        return {**rate(ms, batch_size), "exit_layers": int(last["pred"]["exit_layer"].max()) + 1}

    head = measure(exit_layers)
    sweep = [measure(k) for k in SWEEP]
    return {
        **head,
        "vs_baseline": None if head["pairs_per_sec"] is None
        else head["pairs_per_sec"] / A100_BASELINE_PAIRS_PER_SEC,
        "depth_confidence": 0.95, "width_confidence": 0.99,
        "sweep": [{"exit_layers": s["exit_layers"], "pairs_per_sec": s["pairs_per_sec"],
                   "spread": s["spread"]} for s in sweep],
        "note": (f"early-exit serving path; exit depth forced to {exit_layers}/{N_LAYERS} via "
                 "the confidence-head biases (random weights never exit on random inputs); "
                 "one host read of the stop flags a layer; `sweep` is pairs/s against exit "
                 "depth at 3/5/7/9 layers"),
    }


def _compare(graphed: dict, eager: dict) -> dict:
    """Bit equality of every output, or the log assignment within the bf16
    gate and the matches equal; raises ValueError beyond that."""
    if all(torch.equal(graphed[k], eager[k]) for k in eager):
        return {"outputs": "bit-equal to the eager forward's"}
    la, ref = graphed["log_assignment"], eager["log_assignment"]
    valid = ref > -1e8
    diff = float((la - ref)[valid].abs().max())
    if not (diff <= BF16_GATE and torch.equal(graphed["matches0"], eager["matches0"])):
        raise ValueError(f"graphed outputs differ from the eager forward's: {diff}")
    return {"outputs": f"within the bf16 gate {BF16_GATE} of the eager forward's", "max_abs_diff": diff}


def capture(fn, gen=None):
    """`fn()` captured once in a torch.cuda.CUDAGraph after a warm-up on a
    side stream: (graph, its outputs). `gen`, the keypoint fill's
    generator, is registered with the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    register = getattr(graph, "register_generator_state", None)
    if gen is not None and register is not None:
        register(gen)
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph, out


def bench_graphed(forward, eager: dict, iters: int, batch_size: int, gen) -> dict:
    """The dense forward captured once and replayed: the forward without
    the host's launch time."""
    gen.manual_seed(0)
    graph, out = capture(lambda: forward(gen), gen)
    check = _compare(out, eager)
    return {**rate(time_forward(graph.replay, iters, torch.device("cuda")), batch_size), **check}


def bench_graphed_matcher(matcher, data: dict, iters: int, batch_size: int) -> dict:
    """LightGlue alone on the extracted features, eager against captured
    and replayed: what a graph saves on the matcher's many small kernels."""
    eager = matcher(data)
    ms = time_forward(lambda: matcher(data), iters, torch.device("cuda"))
    graph, out = capture(lambda: matcher(data))
    check = _compare(out, eager)
    graphed = rate(time_forward(graph.replay, iters, torch.device("cuda")), batch_size)
    return {"eager": rate(ms, batch_size), "graphed": graphed, **check}


def failure(e: Exception) -> dict:
    """An error for the JSON line: its message and the innermost line of
    the port that raised it."""
    import traceback

    at = [f"{Path(f.filename).relative_to(ROOT)}:{f.lineno}: {f.line}"
          for f in traceback.extract_tb(e.__traceback__)
          if f.filename.startswith(str(ROOT / "gluefactory_tpu_torch"))]
    return {"error": str(e)[:300], "at": at[-1] if at else None}


def main(device: str | torch.device = "cuda", batch: int = BATCH, image_size: int = IMAGE_SIZE,
         keypoints: int = NUM_KEYPOINTS, iters: int = ITERS, exit_layers: int = EXIT_LAYERS) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.build_all(["fused_attention", "fused_bidirectional_attention", "int8_conv"])
    torch.manual_seed(0)  # random weights from a seed
    model = get_model("two_view_pipeline").from_conf(pipeline_conf(keypoints, QUANTIZE, INT8_SIM),
                                                     device=device)
    model = model.to(torch.bfloat16).eval()
    data = make_batch(device, batch, image_size)
    gen = torch.Generator(device=device)

    def forward(generator):
        return model(data, generator=generator)

    with torch.no_grad():
        eager = forward(gen.manual_seed(0))
        ms = time_forward(lambda: forward(gen.manual_seed(0)), iters, device)
        flops = count_flops(lambda: forward(gen.manual_seed(0)))
        flops += attention_flops(batch, keypoints, model.matcher.conf)
        flops += int8_ops(batch, image_size, keypoints, model)
        head = rate(ms, batch)
        pps = head["pairs_per_sec"]
        tag = "int8 extract, bf16 match" if QUANTIZE == "int8" else "bf16"
        if INT8_SIM == "1":
            tag += ", int8 similarity"
        result = {
            "metric": (f"image pairs/s (SP+LightGlue, {keypoints} kpts, {image_size}px, {tag}, "
                       "PyTorch eager + CUDA kernels)"),
            "value": pps,
            "unit": "pairs/s",
            "vs_baseline": None if pps is None else pps / A100_BASELINE_PAIRS_PER_SEC,
            "spread": head["spread"],
            "repeats_ms": head["repeats_ms"],
            "gflops_per_pair": flops / batch / 1e9,
            "mfu": None if pps is None else flops / batch * pps / H100_BF16_PEAK_FLOPS,
        }
        try:
            result["pruned"] = bench_pruned(model, data, device, batch, iters, exit_layers)
        except RuntimeError as e:  # the headline metric survives a pruned failure
            result["pruned"] = failure(e)
        if device.type == "cuda":
            for key, run in (("graphed", lambda: bench_graphed(forward, eager, iters, batch, gen)),
                             ("graphed_matcher", lambda: bench_graphed_matcher(
                                 model.matcher, {**data, **eager}, iters, batch))):
                try:
                    result[key] = run()
                except (RuntimeError, ValueError) as e:
                    result[key] = failure(e)
        else:
            result["graphed"] = result["graphed_matcher"] = {"error": "CUDA graphs need a CUDA device"}
    name, _, limit = card(device).partition(", ")
    result["device"] = {"name": name, "power_limit": limit or None,
                        "count": torch.cuda.device_count() if device.type == "cuda" else 0}
    return result


if __name__ == "__main__":
    print(json.dumps(main()))
    sys.stdout.flush()
