"""The homography dataset on a folder of images against the JAX package's
`HomographyDataset`, on a fabricated folder: JPEG and PNG images (one in a
subfolder), a small image that is upscaled to cover `source_size`, and an
unreadable file that gives the zero image. The listings (`image_dir` by
glob, `image_list` as a file and as a list) and the splits are identical;
every item is identical but for the warp of its views, which the port holds
to cv2 within float32 ulps (`tests/test_torch_homographies.py`): the images
within 1e-6, the homographies bit-equal."""

import cv2
import numpy as np
import pytest

from gluefactory_tpu.data.homographies import HomographyDataset as JaxDataset
from gluefactory_tpu_torch.data.homographies import HomographyDataset, generate_synthetic_image

BASE = {"source_size": [96, 72], "train_size": 6, "val_size": 2,
        "homography": {"patch_shape": [64, 48]}}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    (d / "sub").mkdir()
    for i in range(6):
        img = (generate_synthetic_image(i, (160, 120)) * 255).astype(np.uint8)[..., ::-1]
        cv2.imwrite(str(d / ("sub" if i % 2 else "") / f"im{i}.{'jpg' if i % 3 else 'png'}"), img)
    cv2.imwrite(str(d / "small.jpg"), (generate_synthetic_image(9, (50, 31)) * 255).astype(np.uint8))
    (d / "broken.jpg").write_bytes(b"not an image")
    (d / "list.txt").write_text("im0.png\nsub/im1.jpg\nsmall.jpg\nbroken.jpg\n")
    return d


CASES = {
    "glob": {},
    "list_file": {"image_list": "list.txt"},
    "list": {"image_list": ["im0.png", "small.jpg", "sub/im3.jpg", "broken.jpg"]},
    "lg": {"photometric": {"name": "lg"}},
    "right_only_triplet": {"right_only": True, "triplet": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_items_match_jax(folder, case):
    conf = {**BASE, "image_dir": str(folder), **CASES[case]}
    ours, theirs = HomographyDataset(conf), JaxDataset(conf)
    for split in ("train", "val"):
        a, b = ours.get_dataset(split), theirs.get_dataset(split)
        assert [str(n) for n in a.image_names] == [str(n) for n in b.image_names]
        for i in range(len(a)):
            got, want = a[i], b[i]
            assert got.keys() == want.keys()
            for key in got:
                if key.startswith("view"):
                    assert got[key].keys() == want[key].keys()
                    np.testing.assert_array_equal(got[key]["image_size"], want[key]["image_size"])
                    assert got[key]["image"].shape == want[key]["image"].shape
                    assert np.abs(got[key]["image"] - want[key]["image"]).max() <= 1e-6
                elif key == "name":
                    assert got[key] == want[key]
                else:
                    np.testing.assert_array_equal(got[key], want[key])


def test_read_image_zero_and_upscale(folder):
    conf = {**BASE, "image_dir": str(folder), "image_list": ["small.jpg", "broken.jpg"],
            "val_size": 0}
    ours, theirs = HomographyDataset(conf).get_dataset("train"), JaxDataset(conf).get_dataset("train")
    for i, name in enumerate(ours.image_names):
        img, scale = ours._read_image(i)
        want, want_scale = theirs._read_image(i)
        assert img.shape == want.shape and np.abs(img - want).max() <= 1e-6
        np.testing.assert_array_equal(scale, want_scale)
        if name.name == "broken.jpg":
            assert img.shape == (72, 96, 3) and not img.any()
        else:
            assert img.shape[0] >= 72 and img.shape[1] >= 96 and (scale > 1).all()


def test_missing_list_and_files_raise(folder):
    for conf in ({"image_list": "nope.txt"}, {"image_list": ["gone.jpg"], "check_file_exists": True}):
        for cls in (HomographyDataset, JaxDataset):
            with pytest.raises(FileNotFoundError):
                cls({**BASE, "image_dir": str(folder), **conf})
    for cls in (HomographyDataset, JaxDataset):
        with pytest.raises(FileNotFoundError):
            cls({**BASE, "image_dir": str(folder / "absent")})


def test_default_folder_under_data_path(folder, monkeypatch):
    """Without `image_dir`: DATA_PATH/data_dir/jpg, and a relative
    `image_list` under DATA_PATH/data_dir."""
    from gluefactory_tpu_torch.data import homographies

    root = folder.parent
    (root / "corpus").mkdir(exist_ok=True)
    if not (root / "corpus" / "jpg").exists():
        (root / "corpus" / "jpg").symlink_to(folder)
    (root / "corpus" / "names.txt").write_text("im0.png\nsub/im3.jpg\n")
    monkeypatch.setattr(homographies, "DATA_PATH", root)
    ds = HomographyDataset({**BASE, "data_dir": "corpus", "image_list": "names.txt", "val_size": 0})
    assert sorted(p.name for p in ds.images["train"]) == ["im0.png", "im3.jpg"]
    ds = HomographyDataset({**BASE, "data_dir": "corpus"})
    assert len(ds.images["train"]) + len(ds.images["val"]) == 8
