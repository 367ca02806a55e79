"""The port stands alone (no JAX, nothing of `gluefactory_tpu`, no OpenCV,
no Pillow, no h5py at import),
and every kernel wrapper sends CUDA tensors to its kernel with no fallback."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gluefactory_tpu_torch.ops import (
    _build,
    assignment,
    attention,
    cuda_attention,
    cuda_conv,
    cuda_detect,
    cuda_sinkhorn,
)

ROOT = Path(__file__).resolve().parents[1]

_GUARD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["cv2"] = None
sys.modules["PIL"] = None
sys.modules["h5py"] = None
import gluefactory_tpu_torch.train, gluefactory_tpu_torch.data.homographies
import gluefactory_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "gluefactory_tpu" or m.startswith("gluefactory_tpu."))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 140, names
for name in ("train", "optim", "settings", "data.homographies", "data.base_dataset", "data.augmentations",
             "data.raster", "data.colour", "data.jpeg", "data.preprocess", "geometry.homography", "geometry.gt_generation", "models.losses",
             "models.metrics", "models.matchers.homography_matcher", "utils.experiments",
             "utils.stdout_capturing", "utils.tensor", "utils.tools",
             "ops.cuda_sinkhorn", "ops.cuda_detect", "ops.cuda_conv", "models.matchers.superglue",
             "models.matchers.lightglue_serving",
             "ops.cuda_conv3x3", "scripts_dev", "scripts_dev.timing", "scripts_dev.conv_study",
             "scripts_dev.profile_stream_conv", "scripts_dev.profile_npack",
             "data.hpatches", "utils.threefry", "utils.export_predictions", "ops.ransac",
             "robust_estimators", "robust_estimators.base_estimator",
             "robust_estimators.homography.xla_ransac", "robust_estimators.homography.opencv",
             "eval", "eval.eval_pipeline", "eval.io", "eval.utils", "eval.hpatches",
             "visualization.viz2d", "geometry.utils", "geometry.wrappers", "geometry.epipolar",
             "geometry.depth", "data.geometry_io", "data.posed_images", "data.image_pairs",
             "ops.essential5", "robust_estimators.relative_pose",
             "robust_estimators.relative_pose.xla_ransac",
             "robust_estimators.relative_pose.opencv", "eval.megadepth1500",
             "eval.scannet1500", "data.hdf5", "data.megadepth", "data.utils",
             "models.matchers.depth_matcher", "scripts", "scripts.make_scene_lists",
             "scripts_dev.posed_scenes", "utils.hdf5_write", "models.cache_loader",
             "scripts.export_megadepth", "scripts.export_local_features", "data.image_folder",
             "models.matchers.nearest_neighbor_matcher", "models.triplet_pipeline", "utils.misc",
             "data.eth3d", "data.zeb", "eval.eth3d", "eval.zeb", "models.matchers.adalam",
             "models.lines.lsd", "models.lines.wireframe", "models.matchers.gluestick",
             "geometry.gt_lines", "robust_estimators.homography.homography_est",
             "models.extractors.aliked", "models.extractors.disk", "models.extractors.superpoint_open",
             "ops.batch_norm", "ops.sift", "models.extractors.sift", "models.extractors.sift_kornia",
             "models.backbones", "models.backbones.resnet_fpn", "models.matchers.loftr",
             "models.backbones.dinov2", "models.matchers.roma_net", "models.matchers.roma",
             "models.extractors.grid_extractor", "models.extractors.mixed",
             "models.matchers.lightglue_pretrained", "models.extractors.keynet_affnet_hardnet",
             "ops.warp", "data.device_homography", "models.lines.deeplsd", "ops.hough",
             "utils.distributed", "ops.int8_conv", "ops.s2d_conv", "robust_estimators.native",
             "robust_estimators.homography.poselib", "robust_estimators.relative_pose.poselib",
             "robust_estimators.relative_pose.two_view_native", "utils.benchmark", "utils.patches"):
    assert pkg.__name__ + "." + name in names, name
"""


def test_port_imports_without_jax_or_the_jax_package():
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_module_imports_h5py_jax_or_the_jax_package_anywhere():
    """Not at import, and not inside a function either: HDF5 goes through
    the port's own reader (`data/hdf5.py`)."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(h5py|jax|flax|optax|gluefactory_tpu)\b", re.M)
    files = sorted((ROOT / "gluefactory_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    found = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}" for p in files
             for m in pattern.finditer(p.read_text())]
    assert not found, found


def test_lines_and_the_host_build_never_import_cv2():
    """The LSD and the Hough are the port's own C++: no OpenCV in
    `models/lines/`, `ops/hough.py` or `ops/_build.py`, not even inside a
    function."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+cv2\b", re.M)
    files = sorted((ROOT / "gluefactory_tpu_torch" / "models" / "lines").rglob("*.py"))
    files += [ROOT / "gluefactory_tpu_torch" / "ops" / name for name in ("_build.py", "hough.py")]
    assert len(files) >= 6
    assert not [str(p) for p in files if pattern.search(p.read_text())]


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


def _no_build(monkeypatch):
    def no_build(name):
        raise RuntimeError(f"CUDA kernel build failed: {name}")

    monkeypatch.setattr(_build, "load", no_build)


def _never(*args, **kwargs):
    raise AssertionError("plain version used on the kernel path")


def test_new_kernels_never_fall_back(monkeypatch):
    """Sinkhorn, detect and VGG: a tensor that dispatches to the kernel gets
    the kernel or an error, through the wrapper and through the op that
    calls it; the plain version is never run."""
    _no_build(monkeypatch)
    for mod, plain in ((cuda_sinkhorn, "plain_log_sinkhorn"), (cuda_detect, "nms_tile_reduce_plain"),
                       (cuda_conv, "vgg_block_plain")):
        monkeypatch.setattr(mod, "uses_kernel", lambda device: True)
        monkeypatch.setattr(mod, plain, _never)
    monkeypatch.setattr(assignment, "plain_log_sinkhorn", _never)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="build failed"):
        assignment.log_optimal_transport(torch.randn(1, 6, 7, generator=g), torch.tensor(1.0), 3)
    with pytest.raises(RuntimeError, match="build failed"):
        cuda_detect.detect_keypoints(torch.rand(1, 32, 32, generator=g), 4, 0.0)
    x = torch.randn(1, 8, 8, 8, generator=g)
    with pytest.raises(RuntimeError, match="build failed"):
        cuda_conv.fused_vgg_block(x, torch.randn(3, 3, 8, 16), torch.randn(16))


def test_new_wrappers_on_cpu_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("kernel loaded for a CPU tensor"))
    for mod in (cuda_sinkhorn, cuda_detect, cuda_conv):
        mod.reset_launches()
    g = torch.Generator().manual_seed(1)
    Z, mu, nu = torch.randn(2, 5, 6, generator=g), torch.randn(2, 5), torch.randn(2, 6)
    torch.testing.assert_close(cuda_sinkhorn.log_sinkhorn(Z, mu, nu, 4),
                               cuda_sinkhorn.plain_log_sinkhorn(Z, mu, nu, 4))
    s = torch.rand(1, 32, 32, generator=g)
    for got, want in zip(cuda_detect.fused_nms_tile_reduce(s), cuda_detect.nms_tile_reduce_plain(s)):
        torch.testing.assert_close(got, want)
    x, w, b = torch.randn(1, 8, 8, 8, generator=g), torch.randn(3, 3, 8, 16), torch.randn(16)
    torch.testing.assert_close(cuda_conv.fused_vgg_block(x, w, b), cuda_conv.vgg_block_plain(x, w, b))
    assert cuda_sinkhorn.launches == {"log_sinkhorn": 0}
    assert cuda_detect.launches == {"fused_nms_tile_reduce": 0}
    assert cuda_conv.launches == {"fused_vgg_block": 0}


def test_new_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    for mod in (cuda_sinkhorn, cuda_detect, cuda_conv):
        monkeypatch.setattr(mod, "uses_kernel", lambda device: True)
    with pytest.raises(ValueError, match="marginals"):
        cuda_sinkhorn.log_sinkhorn(torch.zeros(1, 4, 5), torch.zeros(1, 5), torch.zeros(1, 5), 2)
    with pytest.raises(ValueError, match="tile"):
        cuda_detect.fused_nms_tile_reduce(torch.zeros(1, 30, 32))
    with pytest.raises(TypeError, match="dtype"):
        cuda_detect.fused_nms_tile_reduce(torch.zeros(1, 32, 32, dtype=torch.float16))
    with pytest.raises(ValueError, match="radius"):
        cuda_detect.fused_nms_tile_reduce(torch.zeros(1, 32, 32), radius=9)
    with pytest.raises(ValueError, match="iterations"):  # the halo covers 2
        cuda_detect.fused_nms_tile_reduce(torch.zeros(1, 32, 32), radius=6, iters=3)
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_conv.fused_vgg_block(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 16), torch.zeros(16))
    with pytest.raises(ValueError, match="do not fit"):
        cuda_conv.fused_vgg_block(torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 16, 16), torch.zeros(16))


_BENCH_GUARD = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import bench_torch, chip_smoke
leaked = sorted(m for m in sys.modules if m == "gluefactory_tpu" or m.startswith("gluefactory_tpu."))
assert not leaked, leaked
"""


def test_bench_and_smoke_scripts_import_without_jax():
    res = subprocess.run([sys.executable, "-c", _BENCH_GUARD], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
