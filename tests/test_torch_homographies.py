"""The port's homography dataset against the JAX package's.

- `H_0to1` of the same `(seed, epoch, idx)` equal to JAX's items', and each
  view's H equal to JAX's `sample_homography_corners` on the same generator;
- the warped patches against cv2's (the JAX dataset's) on every pixel,
  the border ring included. The port repeats the float32 arithmetic of
  cv2's vector loop (with fused multiply-add, at most 16 lanes: SSE4/AVX2
  with FMA, AVX-512, NEON). The columns that loop covers at any such width,
  all but a row's last `pw % 16`, hold within 1e-5. cv2's scalar tail
  rounds the source coordinate once more, so there the bound is 4 ulps of a
  coordinate of the source's size, times the largest step of an image in
  [0, 1], which is 1;
- the procedural images on >= 98% of pixels within 1e-6 (the rasteriser
  against cv2's drawing);
- `collate` and the loader's item order (shuffled from `conf.seed`);
- the options that are not ported raise `NotImplementedError`; `lg`,
  `dark` and `load_features` keep `H_0to1` bit-equal to JAX's.
"""

import numpy as np
import pytest
import torch

from gluefactory_tpu.data import base_dataset as jbase
from gluefactory_tpu.data.homographies import HomographyDataset as JaxHomographyDataset
from gluefactory_tpu.data.homographies import generate_synthetic_image as jax_image
from gluefactory_tpu.data.homographies import warp_patch as cv2_warp
from gluefactory_tpu.geometry.homography import sample_homography_corners as jax_sample
from gluefactory_tpu_torch.data import base_dataset, get_dataset
from gluefactory_tpu_torch.data.homographies import (HomographyDataset, generate_synthetic_image,
                                                     warp_patch)
from gluefactory_tpu_torch.geometry.homography import sample_homography_corners

CONF = {"synthetic_images": 12, "train_size": 8, "val_size": 3, "source_size": [160, 120],
        "homography": {"patch_shape": [128, 96], "difficulty": 0.7, "max_angle": 45},
        "photometric": {"name": "identity"}, "batch_size": 3, "seed": 3}


@pytest.fixture(scope="module")
def items():
    """(port item, JAX item) of the training split at epochs 0 and 1."""
    ours, theirs = HomographyDataset(CONF), JaxHomographyDataset(CONF)
    out = []
    for epoch in (0, 1):
        ours.epoch = theirs.epoch = epoch
        a, b = ours.get_dataset("train"), theirs.get_dataset("train")
        out += [(a[i], b[i]) for i in (0, 3, 7)]
    return out


def test_homographies_equal_jax(items):
    for ours, theirs in items:
        np.testing.assert_array_equal(ours["H_0to1"], theirs["H_0to1"])
        assert ours["idx"] == theirs["idx"] and ours["name"] == theirs["name"]
        np.testing.assert_array_equal(ours["original_image_size"], theirs["original_image_size"])
    assert not np.array_equal(items[0][0]["H_0to1"], items[3][0]["H_0to1"])  # reseeded by epoch


@pytest.mark.parametrize("difficulty", [0.0, 0.5, 0.9])
def test_sample_homography_corners_equal_jax(difficulty):
    for seed in range(5):
        args = ((640, 480), (320, 240), difficulty, 1.0, 10, 45)
        ours = sample_homography_corners(*args, rng=np.random.default_rng(seed))
        theirs = jax_sample(*args, rng=np.random.default_rng(seed))
        for a, b in zip(ours[:3], theirs[:3]):
            np.testing.assert_array_equal(a, b)


def test_warped_patches_against_cv2():
    """Procedural and uniform-noise images, one and three channels, patches
    smaller than, equal to and larger than the source; every pixel."""
    rng = np.random.default_rng(0)
    worst, worst_tail = 0.0, 0.0
    for seed in range(6):
        for src, patch, difficulty, channels in (((160, 120), (128, 96), 0.8, 3),
                                                 ((97, 61), (120, 80), 0.9, 1),
                                                 ((320, 240), (320, 240), 0.5, 3)):
            if seed % 2:
                img = rng.uniform(0, 1, (src[1], src[0], channels)).astype(np.float32)
            else:
                img = jax_image(seed, src)[..., :channels]
            H = sample_homography_corners(src, patch, difficulty, 1.0, 10, 60, rng=rng)[0]
            ours, theirs = warp_patch(img, H, patch), cv2_warp(img, H, patch)
            assert ours.shape == theirs.shape == (patch[1], patch[0], channels)
            diff = np.abs(ours - theirs)
            vec = patch[0] - patch[0] % 16
            worst = max(worst, float(diff[:, :vec].max()))
            tail_bound = 4 * float(np.spacing(np.float32(max(src))))
            worst_tail = max(worst_tail, float(diff.max()) / tail_bound)
    assert worst <= 1e-5, worst
    assert worst_tail <= 1.0, worst_tail


def test_dataset_patches_against_cv2(items):
    for ours, theirs in items[:3]:
        for v in ("view0", "view1"):
            a, b = ours[v]["image"], theirs[v]["image"]
            assert a.shape == b.shape == (96, 128, 3) and a.dtype == np.float32
            np.testing.assert_array_equal(ours[v]["image_size"], theirs[v]["image_size"])
            assert (np.abs(a - b).max(-1) <= 2e-2).mean() >= 0.99


@pytest.mark.parametrize("size", [(640, 480), (160, 120), (97, 61)])
def test_synthetic_images_agree_with_cv2(size):
    for seed in range(4):
        a, b = generate_synthetic_image(seed, size), jax_image(seed, size)
        assert a.shape == b.shape == (size[1], size[0], 3)
        assert (np.abs(a - b) <= 1e-6).all(-1).mean() >= 0.98


def test_collate_matches_jax(items):
    ours = base_dataset.collate([o for o, _ in items[:3]])
    theirs = jbase.collate([t for _, t in items[:3]])
    assert ours["name"] == theirs["name"]
    assert ours["idx"].dtype == torch.int64
    np.testing.assert_array_equal(ours["idx"].numpy(), theirs["idx"])
    np.testing.assert_array_equal(ours["H_0to1"].numpy(), theirs["H_0to1"])
    assert ours["view0"]["image"].shape == (3, 96, 128, 3)


def test_loader_order_matches_jax():
    ours = get_dataset("homographies")(CONF).get_data_loader("train")
    theirs = JaxHomographyDataset(CONF).get_data_loader("train")
    got = [b["idx"].tolist() for b in ours]
    want = [b["idx"].tolist() for b in theirs]
    assert got == want and len(got) == 2 and got != [[0, 1, 2], [3, 4, 5]]
    val = [b["name"] for b in get_dataset("homographies")(CONF).get_data_loader("val")]
    assert val == [b["name"] for b in JaxHomographyDataset(CONF).get_data_loader("val")]


@pytest.mark.parametrize("options", [{"grayscale": True, "triplet": True},
                                     {"right_only": True, "triplet": True}],
                         ids=["grayscale_triplet", "right_only"])
def test_view_options(options):
    conf = {**CONF, **options}
    item = HomographyDataset(conf).get_dataset("train")[0]
    ref = JaxHomographyDataset(conf).get_dataset("train")[0]
    channels = 1 if options.get("grayscale") else 3
    assert item["view2"]["image"].shape == (96, 128, channels)
    for k in ("H_0to1", "H_0to2", "H_1to2"):
        np.testing.assert_array_equal(item[k], ref[k])
    for v in ("view0", "view1", "view2"):
        assert (np.abs(item[v]["image"] - ref[v]["image"]) <= 2e-2).mean() >= 0.99


@pytest.mark.parametrize("override,error", [
    ({"photometric": {"name": "lg"}}, None), ({"photometric": {"name": "dark"}}, None),
    ({"synthetic_images": 0}, FileNotFoundError), ({"load_features": {"do": True}}, None),
    ({"detect_lines": {"do": True}}, NotImplementedError), ({"emit_source": True}, NotImplementedError),
], ids=["lg", "dark", "folders", "load_features", "detect_lines", "emit_source"])
def test_not_ported_options_raise(override, error, monkeypatch, tmp_path):
    """`detect_lines` and `emit_source` raise NotImplementedError. The
    photometric families `lg` and `dark` are ported: they draw from the
    item's generator as JAX's do, so the next view's homography and
    `H_0to1` stay bit-equal to JAX's. `load_features` is ported (a cache
    of every procedural image, keyed by its index in both packages), and
    draws nothing. Image folders are ported: without `synthetic_images`
    the dataset lists DATA_PATH/revisitop1m/jpg, absent here, and raises
    FileNotFoundError as JAX's does."""
    from gluefactory_tpu_torch.data import homographies
    from gluefactory_tpu_torch.utils.hdf5_write import H5Writer

    monkeypatch.setattr(homographies, "DATA_PATH", tmp_path)
    if "load_features" in override:
        rng = np.random.default_rng(0)
        with H5Writer(tmp_path / "c.h5") as f:
            for i in range(CONF["synthetic_images"]):
                g = f.create_group(str(i))
                g.create_dataset("keypoints", data=rng.uniform(0, 160, (20, 2)).astype(np.float32))
                g.create_dataset("keypoint_scores", data=rng.random(20).astype(np.float32))
        override = {"load_features": {"do": True, "path": str(tmp_path / "c.h5")}}
    if error is not None:
        with pytest.raises(error):
            HomographyDataset({**CONF, **override})
        return
    ours = HomographyDataset({**CONF, **override}).get_dataset("train")
    theirs = JaxHomographyDataset({**CONF, **override}).get_dataset("train")
    for i in (0, 5):
        np.testing.assert_array_equal(ours[i]["H_0to1"], theirs[i]["H_0to1"])


def test_raster_against_cv2():
    """The rasteriser against cv2's drawing on random shapes in a 640 x 480
    float image: rectangles and circles on every pixel, triangles (one in
    ten with a horizontal edge) on all but 1e-5 of the pixels cv2 fills."""
    import cv2

    from gluefactory_tpu_torch.data.raster import fill_circle, fill_poly, fill_rect

    rng = np.random.default_rng(1)
    w, h = 640, 480
    bad = {"rect": 0, "circle": 0, "poly": 0}
    filled = 0
    for t in range(60):
        for kind in bad:
            a = np.zeros((h, w), np.float32)
            b = a.copy()
            if kind == "rect":
                p1, p2 = (tuple(int(v) for v in rng.integers(0, [w, h])) for _ in range(2))
                cv2.rectangle(a, p1, p2, 1.0, -1)
                fill_rect(b, p1, p2, 1.0)
            elif kind == "circle":
                c = tuple(int(v) for v in rng.integers([-20, -20], [w + 20, h + 20]))
                r = int(rng.integers(0, 60))
                cv2.circle(a, c, r, 1.0, -1)
                fill_circle(b, c, r, 1.0)
            else:
                pts = rng.integers(0, [w, h], size=(3, 2)).astype(np.int32)
                if t % 10 == 0:
                    pts[1, 1] = pts[0, 1]
                cv2.fillPoly(a, [pts], 1.0)
                fill_poly(b, [(int(x), int(y)) for x, y in pts], 1.0)
                filled += int(a.sum())
            bad[kind] += int((a != b).sum())
    assert bad["rect"] == 0 and bad["circle"] == 0, bad
    assert bad["poly"] <= 1e-5 * filled, (bad, filled)
