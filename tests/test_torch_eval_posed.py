"""The relative-pose benchmarks' data in the port against the JAX package on
the CPU: procedural posed scenes (`scripts_dev/posed_scenes.py`: JPEG
images and 16-bit PNG depths written by Pillow, a PINHOLE and a
SIMPLE_RADIAL scene) read by both packages' `posed_images` datasets, and
calibrated pairs by both `image_pairs` datasets. Every array of every item
bit-equal (images through Pillow against cv2, the `area` resize, the depths'
`nearest` resize, cameras, `T_w2cam`, `T_0to1` in float64 rounded to
float32), every other value equal. `resize_image(..., "nearest")` bit-equal
to cv2's INTER_NEAREST at up- and down-scales of odd sizes, on HW and HW1
float32; `load_depth` of a PNG equal to `cv2.imread(IMREAD_ANYDEPTH) / 256`
and of an HDF5 file to h5py's; `prepare_batch`'s cameras and poses.
"""

import sys

import cv2
import h5py
import numpy as np
import pytest
import torch

from gluefactory_tpu.data import get_dataset as jax_get_dataset
from gluefactory_tpu.data import posed_images as jpi
from gluefactory_tpu.data.base_dataset import prepare_batch as jax_prepare_batch
from gluefactory_tpu_torch.data import get_dataset, posed_images
from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
from gluefactory_tpu_torch.data.preprocess import resize_image
from gluefactory_tpu_torch.geometry.wrappers import Camera, Pose
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_image_pairs, write_posed_images

SIZE = (160, 120)
MD_CONF = {"root": "megadepth1500", "depth_dir": "{scene}/depths", "depth_format": "png",
           "preprocessing": {"resize": 100, "side": "long", "interpolation": "area", "antialias": False},
           "num_workers": 0}
PAIRS_CONF = {"pairs": "scannet1500/pairs_calibrated.txt", "root": "scannet1500",
              "extra_data": "relative_pose", "preprocessing": {"resize": 120, "side": "long"},
              "num_workers": 0}


def write_layouts(root):
    """Two posed scenes (3 + 2 pairs) under `root/megadepth1500` and 3
    calibrated pairs under `root/scannet1500`."""
    md = root / "megadepth1500"
    write_posed_images(md, "s0", n_views=3, n_pairs=3, size=SIZE, model="PINHOLE", seed=0)
    write_posed_images(md, "s1", n_views=3, n_pairs=2, size=SIZE, model="SIMPLE_RADIAL", seed=1)
    # seed 8: the random model of test_torch_eval_megadepth1500.py matches 6-8
    # points a pair there with every assignment decision clear by >= 1e-4
    lines = write_image_pairs(root / "scannet1500", "scene0707_00", n_views=3, n_pairs=3, size=SIZE,
                              seed=8)
    (root / "scannet1500" / "pairs_calibrated.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture()
def posed_root(tmp_path, monkeypatch):
    import gluefactory_tpu.data.image_pairs as jip
    import gluefactory_tpu.settings as jsettings
    import gluefactory_tpu_torch.settings as tsettings

    write_layouts(tmp_path)
    for mod in (jsettings, jpi, jip, tsettings):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    return tmp_path


def assert_items_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_items_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name,conf", [("posed_images", MD_CONF), ("image_pairs", PAIRS_CONF)])
def test_items_equal_jax(posed_root, name, conf):
    got = get_dataset(name)(conf).get_dataset("test")
    want = jax_get_dataset(name)(conf).get_dataset("test")
    assert len(got) == len(want) == (5 if name == "posed_images" else 3)
    for i in range(len(want)):
        assert_items_equal(got[i], want[i])
    item = got[0]
    if name == "posed_images":
        assert item["view0"]["depth"].shape == item["view0"]["image"].shape[:2] == (75, 100)
        assert 0.5 < item["view0"]["valid_depth"].mean() <= 1  # the planes fill the views
        assert not np.allclose(item["T_0to1"], np.eye(4))


def test_prepare_batch_cameras_and_poses(posed_root):
    ds = get_dataset("posed_images")(MD_CONF).get_dataset("test")
    jds = jax_get_dataset("posed_images")(MD_CONF).get_dataset("test")
    batch = prepare_batch(collate([ds[3], ds[4]]), "cpu")
    from gluefactory_tpu.data.base_dataset import collate as jcollate

    jbatch = jax_prepare_batch(jcollate([jds[3], jds[4]]))
    cam, jcam = batch["view1"]["camera"], jbatch["view1"]["camera"]
    assert isinstance(cam, Camera) and isinstance(batch["T_0to1"], Pose)
    assert isinstance(batch["view0"]["T_w2cam"], Pose) and cam.shape == (2,)
    for k in ("size", "f", "c", "dist"):
        np.testing.assert_array_equal(getattr(cam, k).numpy(), np.asarray(getattr(jcam, k)))
    for k in ("R", "t"):
        np.testing.assert_array_equal(getattr(batch["T_0to1"], k).numpy(),
                                      np.asarray(getattr(jbatch["T_0to1"], k)))
    assert cam.dist.shape == (2, 1)  # SIMPLE_RADIAL
    assert torch.is_tensor(batch["view0"]["image"])


@pytest.mark.parametrize("src,dst", [((7, 5), (23, 17)), ((120, 160), (75, 100)), ((1440, 1920), (1200, 1600)),
                                     ((33, 47), (32, 12)), ((9, 13), (9, 13)), ((1, 5), (3, 11))])
@pytest.mark.parametrize("channels", [None, 1])
def test_resize_nearest_equals_cv2(src, dst, channels):
    shape = src if channels is None else src + (channels,)
    img = np.random.default_rng(src[0]).random(shape).astype(np.float32)
    got, scales = resize_image(img, dst[::-1], "nearest")
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST)
    assert got.shape == dst + (1,) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 0], want)
    np.testing.assert_array_equal(scales, np.array([dst[1] / src[1], dst[0] / src[0]], np.float32))


def test_load_depth(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    depth16 = rng.integers(0, 65536, (37, 53)).astype(np.uint16)
    depth16[0, :4] = [0, 255, 256, 65535]  # low bytes kept
    cv2.imwrite(str(tmp_path / "d.png"), depth16)
    want = cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_ANYDEPTH).astype(np.float32) / 256.0
    got = posed_images.load_depth(tmp_path / "d.png", "png")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jpi.load_depth(tmp_path / "d.png", "png"))
    depth8 = rng.integers(0, 256, (5, 6)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "d8.png"), depth8)
    np.testing.assert_array_equal(posed_images.load_depth(tmp_path / "d8.png", "png"),
                                  jpi.load_depth(tmp_path / "d8.png", "png"))
    with h5py.File(tmp_path / "d.h5", "w") as f:
        f.create_dataset("/depth", data=rng.random((7, 9)).astype(np.float64) * 10)
    np.testing.assert_array_equal(posed_images.load_depth(tmp_path / "d.h5", "h5"),
                                  jpi.load_depth(tmp_path / "d.h5", "h5"))
    # read by data/hdf5.py, h5py or not
    with h5py.File(tmp_path / "d.h5", "r") as f:
        want = f["/depth"][...].astype(np.float32)
    monkeypatch.setitem(sys.modules, "h5py", None)
    np.testing.assert_array_equal(posed_images.load_depth(tmp_path / "d.h5", "h5"), want)
    with pytest.raises(ValueError):
        posed_images.load_depth(tmp_path / "d.png", "exr")


def test_extra_data_and_scene_list(posed_root):
    (posed_root / "megadepth1500" / "s0" / "extra.txt").write_text(
        "# comment\ns0_im00.jpg 0.25 7\ns0_im01.jpg 0.5 8\ns0_im02.jpg 0.75 9\n")
    conf = {**MD_CONF, "depth_dir": None, "scene_list": ["s0"], "extra_data": "{scene}/extra.txt",
            "extra_keys": ["covisibility", "tag"]}
    got = get_dataset("posed_images")(conf).get_dataset("test")
    want = jax_get_dataset("posed_images")(conf).get_dataset("test")
    assert len(got) == len(want) == 3
    assert_items_equal(got[1], want[1])
    assert got[0]["view1"]["covisibility"] == 0.5 and got[0]["view1"]["tag"] == 8
    (posed_root / "megadepth1500" / "s0" / "extra.txt").write_text("missing.jpg 1.0 1\n")
    with pytest.raises(ValueError, match="unknown views"):
        get_dataset("posed_images")(conf)
