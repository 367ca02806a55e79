"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: nvcc builds every CUDA kernel of the main path from `csrc/`,
   one process per source, all at once (`gluefactory_tpu_torch/ops/_build.py`);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, in f32 and bf16, with four mask cases (all valid,
   random partial, side 0 fully masked, side 1 fully masked); then the
   kernel, its plain version, and one PyTorch library call computing the
   same function, timed with CUDA events;
4. main path: `two_view_pipeline` (SuperPoint + LightGlue-9, d=256, 4 heads,
   2048 keypoints, 1024x1024 images, bf16, random weights from seed 0) run
   through its entry point on 4 pairs; launch counts reset just before and
   read just after; outputs checked; the matcher rerun on 512 keypoints per
   view with the plain versions forced in, against the kernel run;
5. a torch.profiler window over one forward: device time by kernel.

Prints the kernel JSON line, the card line, and as its last line
{"ok": true, "device": {...}}. Full results go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops import _build, cuda_attention

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# main path (bench.py's configuration)
PAIRS, IMAGE, KEYPOINTS, LAYERS, DIM, HEADS = 4, 1024, 2048, 9, 256, 4
HEAD_DIM = DIM // HEADS
FORWARDS = 5  # timed forwards on the main path (after one warm-up)
REDUCED_KEYPOINTS = 512

# kernel vs plain on the card. f32: both sum f32 products in another order.
# bf16: outputs round to bf16 (step 2^-9 at |x| ~ 0.5) and the kernel rounds
# probabilities to bf16 before PV, as the TPU kernel does.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    print(f"device: {json.dumps(info)}", flush=True)
    return info


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.build_all()
    seconds = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
    print(f"build: {len(built)} kernels in {seconds:.1f} s "
          + json.dumps({n: round(b["seconds"], 1) for n, b in built.items()}), flush=True)
    return {"seconds": seconds, "logs": {n: b["log"] for n, b in built.items()}}


# --------------------------------------------------------------------------
# 3. kernels
# --------------------------------------------------------------------------


def _masks(gen, B, M, N, dev):
    part0 = torch.rand(B, M, generator=gen, device=dev) > 0.3
    part1 = torch.rand(B, N, generator=gen, device=dev) > 0.3
    ones0 = torch.ones(B, M, dtype=torch.bool, device=dev)
    ones1 = torch.ones(B, N, dtype=torch.bool, device=dev)
    return {
        "all_valid": (ones0, ones1),
        "partial": (part0, part1),
        "side0_masked": (torch.zeros_like(ones0), part1),
        "side1_masked": (part0, torch.zeros_like(ones1)),
    }


def _err(a, b) -> float:
    if isinstance(a, tuple):
        return max(_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def _self_attention_case(dtype, gen, dev):
    """Self-attention of both views stacked: B = 2 * PAIRS, H = HEADS."""
    B, N = 2 * PAIRS, KEYPOINTS
    q, k, v = (torch.randn(B, HEADS, N, HEAD_DIM, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    return (q, k, v), _masks(gen, B, N, N, dev)


def _cross_attention_case(dtype, gen, dev):
    B, N = PAIRS, KEYPOINTS
    qk0, qk1, v0, v1 = (torch.randn(B, HEADS, N, HEAD_DIM, generator=gen, device=dev).to(dtype)
                        for _ in range(4))
    return (qk0, qk1, v0, v1), _masks(gen, B, N, N, dev)


def _bound(n_ops: float, n_bytes: float, dtype) -> tuple[float, str]:
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(dev: torch.device) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    F = torch.nn.functional
    results = []
    specs = [
        ("fused_attention", "gluefactory_tpu_torch/csrc/fused_attention.cu",
         "gluefactory_tpu/ops/pallas_attention.py:55", _self_attention_case),
        ("fused_bidirectional_attention",
         "gluefactory_tpu_torch/csrc/fused_bidirectional_attention.cu",
         "gluefactory_tpu/ops/pallas_attention.py:180", _cross_attention_case),
    ]
    for name, source, replaces, make in specs:
        kernel = getattr(cuda_attention, name)
        plain = (cuda_attention.attention_plain if name == "fused_attention"
                 else cuda_attention.bidirectional_plain)
        parity = []
        timing = {}
        for dtype in (torch.float32, torch.bfloat16):
            tensors, masks = make(dtype, gen, dev)
            for case, (m0, m1) in masks.items():
                if name == "fused_attention":  # side 0 = queries, side 1 = keys
                    args = (*tensors, m1, m0)
                else:
                    args = (*tensors, m0, m1)
                got = kernel(*args)
                torch.cuda.synchronize()
                err = _err(got, plain(*args))
                tol = KERNEL_TOL[dtype]
                parity.append({"dtype": str(dtype).split(".")[-1], "masks": case,
                               "max_abs_err": err, "tol": tol})
                if not err <= tol:
                    fail(f"{name} {dtype} {case}: max abs err {err} > {tol}")
                if case == "side0_masked" and name == "fused_attention":
                    if got.abs().max() != 0:
                        fail(f"{name}: masked query rows are not zero")
            if dtype is not torch.bfloat16:
                continue
            # the main path: bf16, every keypoint valid (force_num_keypoints)
            m0, m1 = masks["all_valid"]
            if name == "fused_attention":
                args = (*tensors, m1, m0)
                q, k, v = tensors
                library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
                BH, M, N, n_in, n_out = q.shape[0] * HEADS, KEYPOINTS, KEYPOINTS, 3, 1
                n_ops = 4.0 * BH * M * N * HEAD_DIM  # QK^T and PV
            else:
                args = (*tensors, m0, m1)
                qk0, qk1, v0, v1 = tensors
                # both directions as one batched call (M == N): queries
                # [qk0; qk1], keys [qk1; qk0], values [v1; v0]
                sq, sk, sv = torch.cat([qk0, qk1]), torch.cat([qk1, qk0]), torch.cat([v1, v0])
                library = lambda: F.scaled_dot_product_attention(sq, sk, sv)  # noqa: E731
                BH, M, N, n_in, n_out = qk0.shape[0] * HEADS, KEYPOINTS, KEYPOINTS, 4, 2
                n_ops = 6.0 * BH * M * N * HEAD_DIM  # sim once, two PV products
            elem = torch.finfo(dtype).bits // 8
            n_bytes = (n_in + n_out) * BH * M * HEAD_DIM * elem + (m0.numel() + m1.numel())
            bound_ms, bound_by = _bound(n_ops, n_bytes, dtype)
            before = dict(cuda_attention.launches)
            timing = {
                "ms": cuda_time_ms(lambda: kernel(*args)),
                "plain_ms": cuda_time_ms(lambda: plain(*args), reps=5),
                "library_ms": cuda_time_ms(library),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "timed_shape": [BH // HEADS, HEADS, M, HEAD_DIM],
            }
            cuda_attention.launches.update(before)  # timing launches are not the main path's
        bf16 = [p["max_abs_err"] for p in parity if p["dtype"] == "bfloat16"]
        results.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(bf16), "tol": KERNEL_TOL[torch.bfloat16],
            **timing, "parity": parity,
        })
        print(f"kernel {name}: parity ok ({len(parity)} cases), "
              f"{timing['ms']:.3f} ms (plain {timing['plain_ms']:.3f}, "
              f"library {timing['library_ms']:.3f}, bound {timing['bound_ms']:.4f})", flush=True)
    return results


# --------------------------------------------------------------------------
# 4. main path
# --------------------------------------------------------------------------


def build_pipeline(device) -> torch.nn.Module:
    torch.manual_seed(0)  # random weights from a seed
    conf = {
        "extractor": {"name": "superpoint", "max_num_keypoints": KEYPOINTS,
                      "detection_threshold": 0.0, "force_num_keypoints": True,
                      "trainable": False},
        "matcher": {"name": "lightglue", "n_layers": LAYERS, "descriptor_dim": DIM,
                    "num_heads": HEADS, "checkpointed": False},
    }
    model = get_model("two_view_pipeline").from_conf(conf, device=device)
    return model.to(torch.bfloat16).eval()


def make_batch(device) -> dict:
    rng = np.random.default_rng(0)
    size = torch.tensor([[float(IMAGE), float(IMAGE)]] * PAIRS, device=device)

    def view():
        img = rng.uniform(0, 1, (PAIRS, IMAGE, IMAGE, 1)).astype(np.float32)
        return {"image": torch.from_numpy(img).to(device, torch.bfloat16), "image_size": size}

    return {"view0": view(), "view1": view()}


def check_outputs(pred: dict) -> None:
    B, K = PAIRS, KEYPOINTS
    expect = {
        "keypoints0": ((B, K, 2), torch.float32),
        "keypoint_scores0": ((B, K), torch.bfloat16),
        "keypoint_mask0": ((B, K), torch.bool),
        "descriptors0": ((B, K, DIM), torch.bfloat16),
        "log_assignment": ((B, K + 1, K + 1), torch.float32),
        "matches0": ((B, K), torch.int32),
        "matches1": ((B, K), torch.int32),
        "matching_scores0": ((B, K), torch.float32),
    }
    for key, (shape, dtype) in expect.items():
        t = pred[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            fail(f"{key}: {tuple(t.shape)} {t.dtype}, expected {shape} {dtype}")
        if t.is_floating_point() and not torch.isfinite(t).all():
            fail(f"{key}: non-finite values")
    for i in "01":
        kp = pred[f"keypoints{i}"]
        if not ((kp >= 0) & (kp <= IMAGE)).all():
            fail(f"keypoints{i} outside the image")
        norms = pred[f"descriptors{i}"].float().norm(dim=-1)
        if not torch.allclose(norms, torch.ones_like(norms), atol=1e-2):
            fail(f"descriptors{i} are not unit vectors")
    m0, m1 = pred["matches0"].long(), pred["matches1"].long()
    for a, b in ((m0, m1), (m1, m0)):
        valid = a >= 0
        if (a >= K).any() or (a < -1).any():
            fail("match index out of range")
        back = torch.gather(b, 1, a.clamp(min=0))
        if not (back[valid] == torch.arange(K, device=a.device).expand(B, K)[valid]).all():
            fail("matches are not mutual: matches0[matches1[j]] != j")


def set_flash(model: torch.nn.Module, enabled: bool) -> None:
    for m in model.modules():
        if hasattr(m, "flash"):
            m.flash = enabled


def compare_with_plain(model, batch, pred) -> dict:
    """The matcher on REDUCED_KEYPOINTS per view of the main path's features:
    kernels vs plain versions, in f32 and in bf16. The bf16 gap is held to
    twice the gap between the plain bf16 and plain f32 runs (bf16 rounding
    alone moves the result that far)."""
    R = REDUCED_KEYPOINTS
    feats = {"view0": {"image_size": batch["view0"]["image_size"]},
             "view1": {"image_size": batch["view1"]["image_size"]}}
    for i in "01":
        for key in ("keypoints", "descriptors", "keypoint_mask"):
            feats[f"{key}{i}"] = pred[f"{key}{i}"][:, :R]
    lg = model.matcher
    lg32 = copy.deepcopy(lg).float()
    feats32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
               for k, v in feats.items()}

    def run(m, f, flash):
        set_flash(m, flash)
        with torch.no_grad():
            out = m(f)
        torch.cuda.synchronize()
        return out

    k16, p16 = run(lg, feats, True), run(lg, feats, False)
    k32, p32 = run(lg32, feats32, True), run(lg32, feats32, False)
    set_flash(lg, True)
    valid = p32["log_assignment"] > -1e8

    def gap(a, b):
        return float((a["log_assignment"] - b["log_assignment"])[valid].abs().max())

    res = {
        "keypoints": R,
        "f32_kernel_vs_plain": gap(k32, p32),
        "f32_tol": 1e-3,
        "bf16_kernel_vs_plain": gap(k16, p16),
        "bf16_plain_vs_f32_plain": gap(p16, p32),
        "bf16_matches0_agreement": float((k16["matches0"] == p16["matches0"]).float().mean()),
    }
    res["bf16_tol"] = max(2.0 * res["bf16_plain_vs_f32_plain"], 1e-2)
    print(f"main path vs plain at {R} keypoints: {json.dumps(res)}", flush=True)
    if not res["f32_kernel_vs_plain"] <= res["f32_tol"]:
        fail(f"f32 matcher: kernels vs plain {res['f32_kernel_vs_plain']}")
    if not res["bf16_kernel_vs_plain"] <= res["bf16_tol"]:
        fail(f"bf16 matcher: kernels vs plain {res['bf16_kernel_vs_plain']} > {res['bf16_tol']}")
    return res


def phase_main_path(device_info: dict) -> dict:
    dev = torch.device("cuda")
    model = build_pipeline(dev)
    batch = make_batch(dev)
    gen = torch.Generator(device=dev)

    cuda_attention.reset_launches()
    with torch.no_grad():
        pred = model(batch, generator=gen.manual_seed(0))  # warm-up and first check
        torch.cuda.synchronize()
        check_outputs(pred)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(FORWARDS):
            pred = model(batch, generator=gen.manual_seed(0))
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    launches = dict(cuda_attention.launches)
    expected = (FORWARDS + 1) * LAYERS
    for name, n in launches.items():
        if n != expected:
            fail(f"{name} launched {n} times on the main path, expected {expected}")
    check_outputs(pred)
    ms = start.elapsed_time(end) / FORWARDS
    res = {
        "pairs": PAIRS, "image": IMAGE, "keypoints": KEYPOINTS, "layers": LAYERS,
        "dtype": "bfloat16", "forwards": FORWARDS + 1,
        "ms_per_forward": ms, "ms_per_pair": ms / PAIRS, "pairs_per_s": PAIRS * 1e3 / ms,
        "host_s_per_forward": host_s / FORWARDS,
        "launches": launches,
        "matches_per_pair": float((pred["matches0"] >= 0).sum()) / PAIRS,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": device_info["nvidia_smi"],
    }
    print(f"main path: {ms / PAIRS:.3f} ms/pair, {PAIRS * 1e3 / ms:.2f} pairs/s "
          f"({device_info['nvidia_smi']}) launches {json.dumps(launches)}", flush=True)
    res["vs_plain"] = compare_with_plain(model, batch, pred)
    res["profile"] = profile_forward(model, batch, gen)
    return res


# --------------------------------------------------------------------------
# 5. profile
# --------------------------------------------------------------------------


def profile_forward(model, batch, gen) -> dict:
    """Device time by kernel over one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    before = dict(cuda_attention.launches)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(batch, generator=gen.manual_seed(0))
        torch.cuda.synchronize()
    cuda_attention.launches.update(before)
    # device-side events only (kernels, copies): operator rows repeat their time
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    attn = sum(r[1] for r in rows if "gf::attention" in r[0])
    top = [{"kernel": k[:120], "ms": ms, "calls": n} for k, ms, n in rows[:25]]
    res = {"device_ms": total, "attention_kernel_ms": attn, "top": top}
    print(f"profile: device {total:.2f} ms per forward, attention kernels {attn:.2f} ms",
          flush=True)
    return res


def main() -> None:
    t0 = time.perf_counter()
    device_info = phase_device()
    build = phase_build()
    kernels = phase_kernels(torch.device("cuda"))
    main_path = phase_main_path(device_info)
    for k in kernels:
        k["launches"] = main_path["launches"][k["name"]]
    OUT_DIR.mkdir(exist_ok=True)
    record = {"device": device_info, "build": build, "kernels": kernels, "main_path": main_path,
              "seconds": time.perf_counter() - t0}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(device_info["nvidia_smi"])
    if not all(math.isfinite(k["ms"]) for k in kernels):
        fail("kernel timing is not finite")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_info["kind"],
                                             "count": device_info["count"]}}))


if __name__ == "__main__":
    main()
