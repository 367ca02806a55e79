"""`scripts/export_megadepth.py` with ALIKED: one procedural scene in
MegaDepth's D2-Net layout (3 views at 128 x 96,
`scripts_dev/posed_scenes.write_megadepth_scene`) exported on the CPU with
a small ALIKED (`aliked-t16`, 64 keypoints, random weights from a seed
passed as `--weights_file`), then read back through `CacheLoader`: a
group for each image, and each image's keypoints, scores and descriptors
equal to ALIKED's on the same processed image within their float16
rounding (keypoints are stored at the original resolution and scaled
back by the loader)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import gluefactory_tpu_torch.settings as tsettings
from gluefactory_tpu_torch.data import get_dataset
from gluefactory_tpu_torch.data.hdf5 import H5File
from gluefactory_tpu_torch.models import cache_loader, get_model
from gluefactory_tpu_torch.scripts import export_megadepth as texp
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene

SIZE, RESIZE = (128, 96), 128
MODEL = {"name": "aliked", "model_name": "aliked-t16", "max_num_keypoints": 64, "detection_threshold": 0.0}
K = MODEL["max_num_keypoints"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_aliked")
    write_megadepth_scene(root / "megadepth", "s0", n_views=3, size=SIZE, seed=0)
    (root / "megadepth" / "scene_lists").mkdir()
    (root / "megadepth" / "scene_lists" / "export.txt").write_text("s0\n")
    torch.manual_seed(0)
    model = get_model("aliked").from_conf({k: v for k, v in MODEL.items() if k != "name"}, device="cpu")
    torch.save(model.state_dict(), root / "aliked.pth")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tsettings, "DATA_PATH", root)
        mp.setitem(texp.METHODS, "aliked", {**texp.METHODS["aliked"], "model": MODEL})
        written = texp.main(["--method", "aliked", "--scenes", "export.txt", "--num_workers", "0",
                             "--resize", str(RESIZE), "--device", "cpu",
                             "--weights_file", str(root / "aliked.pth")])
        items = get_dataset("megadepth")({"train_split": "export.txt", "views": 1,
                                          "train_num_per_scene": None, "read_depth": False,
                                          "preprocessing": {"resize": RESIZE, "side": "long"}})
        items = [items.get_dataset("train")[i] for i in range(3)]
    finally:
        mp.undo()
    return root, written, model.eval(), items


def test_aliked_is_ported_for_export():
    assert {"superpoint_open", "disk", "aliked"} <= texp.PORTED
    assert texp.METHODS["aliked"]["tag"] == "r1024_ALIKED-k2048-n16"


def test_export_reads_back_through_the_cache_loader(exported, monkeypatch):
    root, written, model, items = exported
    tag = "megadepth-undist-depth-" + texp.METHODS["aliked"]["tag"]
    assert [Path(p).name for p in written] == ["s0.h5"]
    with H5File(root / "exports" / tag / "s0.h5") as f:
        assert sorted(f.keys()) == [f"s0_im{i:02d}.jpg" for i in range(3)]
    monkeypatch.setattr(tsettings, "DATA_PATH", root)
    loader = cache_loader.CacheLoader({"path": f"exports/{tag}/{{scene}}.h5"})
    for item in items:
        name = item["name"].split("/", 1)[-1]
        got = loader({"scene": "s0", "name": name, "scales": item["scales"]})
        with torch.no_grad():
            want = model({"image": torch.from_numpy(item["image"][None]),
                          "image_size": torch.from_numpy(item["image_size"][None])})
        kp = np.asarray(got["keypoints"])
        assert kp.shape == (K, 2) and np.asarray(got["descriptors"]).shape == (K, 64)
        # float16 of the original-resolution coordinates, scaled: < 0.07 px at 128 px
        np.testing.assert_allclose(kp, want["keypoints"][0].numpy(), atol=0.07)
        np.testing.assert_allclose(np.asarray(got["keypoint_scores"]), want["keypoint_scores"][0].numpy(),
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(got["descriptors"]), want["descriptors"][0].numpy(), atol=1e-3)
        assert ((kp >= 0) & (kp <= item["image_size"])).all()
