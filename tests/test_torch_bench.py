"""`bench_torch.py` on the CPU at a tiny size: every path runs once and the
JSON line has bench.py's keys (times are null off the card)."""

import json

import pytest

import bench_torch


@pytest.fixture(scope="module")
def tiny_run():
    return bench_torch.main(device="cpu", batch=1, image_size=64, keypoints=32, iters=1)


def test_json_line_has_the_keys(tiny_run):
    line = json.loads(json.dumps(tiny_run))
    for key in ("metric", "value", "unit", "vs_baseline", "gflops_per_pair", "mfu", "pruned",
                "graphed", "device"):
        assert key in line, key
    assert line["unit"] == "pairs/s"
    # a CPU run has no device time
    assert line["value"] is None and line["mfu"] is None and line["pruned"]["pairs_per_sec"] is None
    assert line["graphed"] == {"error": "CUDA graphs need a CUDA device"}
    assert line["device"] == {"name": "cpu", "power_limit": None, "count": 0}
    assert line["gflops_per_pair"] > 0


def test_pruned_exits_where_forced(tiny_run):
    pruned = tiny_run["pruned"]
    assert pruned["exit_layers"] == bench_torch.EXIT_LAYERS
    assert [s["exit_layers"] for s in pruned["sweep"]] == list(bench_torch.SWEEP)
    assert (pruned["depth_confidence"], pruned["width_confidence"]) == (0.95, 0.99)


def test_attention_flops_are_counted_by_hand():
    """FlopCounterMode does not see the kernels: 9 layers of one stacked
    self-attention (4·2B·H·K²·Dh) and one bidirectional call (6·B·H·K²·Dh)."""
    conf = bench_torch.get_model("lightglue").merged_default_conf()
    B, K, H, Dh = 4, 2048, 4, 64
    assert bench_torch.attention_flops(B, K, conf) == 9 * (8 * B + 6 * B) * H * K * K * Dh


@pytest.mark.parametrize("name", ["QUANTIZE", "INT8_SIM"])
def test_unported_options_raise(monkeypatch, name):
    """The int8 switches once raised (not ported); now each runs its int8
    path (the kernels' plain versions on the CPU), names it in the metric
    and counts its int8 products in `gflops_per_pair`."""
    monkeypatch.setattr(bench_torch, name, "int8" if name == "QUANTIZE" else "1")
    line = bench_torch.main(device="cpu", batch=1, image_size=64, keypoints=32, iters=1)
    assert ("int8 extract" if name == "QUANTIZE" else "int8 similarity") in line["metric"]
    conf = bench_torch.pipeline_conf(32, bench_torch.QUANTIZE, bench_torch.INT8_SIM)
    assert (conf["extractor"]["quantize"] == "int8") == (name == "QUANTIZE")
    assert conf["matcher"]["int8_similarity"] == (name == "INT8_SIM")
    model = bench_torch.get_model("two_view_pipeline").from_conf(conf, device="cpu")
    assert bench_torch.int8_ops(1, 64, 32, model) > 0


def test_forced_exit_biases_as_bench_py():
    lg = bench_torch.get_model("lightglue").from_conf(
        {"depth_confidence": 0.95, "width_confidence": 0.99}, device="cpu")
    bench_torch.forced_exit(lg, 5)
    biases = [h.token[0].bias.item() for h in lg.token_confidence]
    assert biases == [-20.0] * 4 + [20.0] * 4
    assert all(not h.token[0].weight.any() for h in lg.token_confidence)
