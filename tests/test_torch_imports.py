"""The port stands alone (no JAX, nothing of `gluefactory_tpu`), and its
attention dispatch sends CUDA tensors to the kernels with no fallback."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gluefactory_tpu_torch.ops import _build, attention, cuda_attention

ROOT = Path(__file__).resolve().parents[1]

_GUARD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import gluefactory_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "gluefactory_tpu" or m.startswith("gluefactory_tpu."))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 15, names
"""


def test_port_imports_without_jax_or_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_dispatch_rule():
    assert cuda_attention.uses_kernel(torch.device("cuda"))
    assert cuda_attention.uses_kernel(torch.device("cuda", 1))
    assert not cuda_attention.uses_kernel(torch.device("cpu"))


def _qkv(n=8, d=32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 2, n, d, generator=g) for _ in range(4)]


def test_kernel_device_never_falls_back(monkeypatch):
    """A tensor that dispatches to the kernel gets the kernel or an error:
    a kernel that cannot be built raises through `mha` and
    `bidirectional_attention`, and the plain version is never run."""
    monkeypatch.setattr(cuda_attention, "uses_kernel", lambda device: True)

    def no_build(name):
        raise RuntimeError(f"CUDA kernel build failed: {name}")

    def plain_called(*args, **kwargs):
        raise AssertionError("plain version used on the kernel path")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(cuda_attention, "attention_plain", plain_called)
    monkeypatch.setattr(cuda_attention, "bidirectional_plain", plain_called)
    q, k, v, _ = _qkv()
    with pytest.raises(RuntimeError, match="build failed"):
        attention.mha(q, k, v)
    with pytest.raises(RuntimeError, match="build failed"):
        attention.bidirectional_attention(q, k, v, v)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("kernel loaded for a CPU tensor"))
    cuda_attention.reset_launches()
    q, k, v, _ = _qkv()
    out = attention.mha(q, k, v)
    m0, m1 = attention.bidirectional_attention(q, k, v, v)
    torch.testing.assert_close(out, cuda_attention.attention_plain(q, k, v))
    assert m0.shape == m1.shape == q.shape
    assert cuda_attention.launches == {"fused_attention": 0, "fused_bidirectional_attention": 0}


def test_failed_build_raises(monkeypatch, tmp_path):
    """nvcc failing is an error with its log, not a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        _build.build_all(["fused_attention"])
    assert not list(tmp_path.glob("*.so"))


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(cuda_attention, "uses_kernel", lambda device: True)
    q, k, v, _ = _qkv(d=48)
    with pytest.raises(ValueError, match="head dim"):
        cuda_attention.fused_attention(q, k, v)
    q, k, v, _ = _qkv()
    with pytest.raises(TypeError, match="dtype"):
        cuda_attention.fused_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="mask"):
        cuda_attention.fused_attention(q, k, v, torch.ones(1, 3, dtype=torch.bool))
