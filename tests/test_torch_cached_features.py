"""Cached features in the port against the JAX package, on the CPU:

- `pad_to_length` / `pad_local_features`: padding, truncation, the edge
  mode and lines, equal to JAX's;
- `CacheLoader` against JAX's on one h5py-written file: float16 descriptors
  cast to float32, `scales`, keys missing from a group, nested names, a bool
  dataset, padding; equal arrays and dtypes;
- the port's HDF5 writer (`utils/hdf5_write.py`): h5py reads every group
  and dataset of a file with more than 300 groups (a B-tree of two levels),
  nested groups, empty datasets and bools, and JAX's `CacheLoader` reads
  its items as the port's does; the port's reader opened before a fork
  serves the children (positioned reads);
- the homography dataset with `load_features`: `_transform_features`
  equal to JAX's, and `__getitem__`'s views and caches equal to JAX's on a
  folder of images. The port keys a file by its path relative to the
  folder, as the export writes it; the JAX dataset looks it up by its
  absolute path, so its cache here holds the same groups under both keys;
- `ImageFolder` items equal to JAX's, and the `export_local_features` CLI
  (SuperPoint on the CPU) writing one group per image that the port's
  `CacheLoader` and h5py read.
"""

import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import gluefactory_tpu.data.image_folder as jif
from gluefactory_tpu.data.homographies import HomographyDataset as JaxHomographyDataset
from gluefactory_tpu.models import cache_loader as jcl
from gluefactory_tpu_torch.data.hdf5 import H5File
from gluefactory_tpu_torch.data.homographies import HomographyDataset
from gluefactory_tpu_torch.data.image_folder import ImageFolder
from gluefactory_tpu_torch.models import cache_loader
from gluefactory_tpu_torch.utils.hdf5_write import H5Writer

ROOT = Path(__file__).resolve().parents[1]


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, (k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("n,length,mode", [(5, 8, "zeros"), (8, 8, "zeros"), (11, 8, "zeros"),
                                           (0, 4, "zeros"), (5, 8, "random_c")])
def test_pad_to_length_equals_jax(n, length, mode):
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    for dim in (0, 1):
        a = x if dim == 0 else x.T
        if mode == "random_c" and a.shape[dim] == 0:
            continue
        got, want = cache_loader.pad_to_length(a, length, dim, mode), jcl.pad_to_length(a, length, dim, mode)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [0, 7, 12, 20])
def test_pad_local_features_equals_jax(n):
    rng = np.random.default_rng(n)
    pred = {"keypoints": rng.uniform(0, 99, (n, 2)).astype(np.float32),
            "keypoint_scores": rng.random(n).astype(np.float32),
            "descriptors": rng.normal(size=(n, 16)).astype(np.float32),
            "scales": rng.random(n).astype(np.float32), "oris": rng.random(n).astype(np.float32),
            "lines": rng.uniform(0, 99, (n // 2, 2, 2)).astype(np.float32),
            "line_scores": rng.random(n // 2).astype(np.float32), "other": np.arange(3)}
    for drop in ((), ("lines", "line_scores"), ("keypoints",)):
        p = {k: v for k, v in pred.items() if k not in drop}
        _assert_same(cache_loader.pad_local_features(p, 12), jcl.pad_local_features(p, 12))


def _write_h5py_cache(path: Path, rng) -> dict:
    """An h5py file as the JAX package's export writes one: float16
    keypoints and descriptors, float32 scores, a bool dataset, nested
    names, a group without scores, an empty group of features."""
    items = {}
    with h5py.File(path, "w") as f:
        for i, name in enumerate(["im0.jpg", "im1.jpg", "sub/dir/im2.jpg", "no_scores.jpg", "empty.jpg"]):
            n = 0 if name == "empty.jpg" else 30 + 5 * i
            arrays = {"keypoints": rng.uniform(0, 300, (n, 2)).astype(np.float16),
                      "keypoint_scores": rng.random(n).astype(np.float32),
                      "descriptors": rng.normal(size=(n, 32)).astype(np.float16),
                      "valid_depth_keypoints": rng.random(n) > 0.3}
            if name == "no_scores.jpg":
                del arrays["keypoint_scores"]
            grp = f.create_group(name)
            for k, v in arrays.items():
                grp.create_dataset(k, data=v)
            items[name] = arrays
    return items


CONFS = {
    "default": {},
    "padded": {"padding_length": 48},
    "bool_and_half": {"data_keys": ["keypoints", "descriptors", "valid_depth_keypoints"],
                      "numeric_type": "float16", "padding_length": 40},
}


@pytest.mark.parametrize("conf", list(CONFS))
def test_cache_loader_equals_jax(tmp_path, conf):
    items = _write_h5py_cache(tmp_path / "scene0.h5", np.random.default_rng(0))
    cfg = {"path": str(tmp_path / "{scene}.h5"), **CONFS[conf]}
    ours, theirs = cache_loader.CacheLoader(cfg), jcl.CacheLoader(cfg)
    for name in items:
        for scales in (None, np.array([0.5, 0.75], np.float32)):
            data = {"scene": "scene0", "name": name, "idx": 3}
            if scales is not None:
                data["scales"] = scales
            got, want = ours(data), theirs(data)
            _assert_same(got, want)
            if conf == "default":
                assert got["descriptors"].dtype == np.float32  # float16 in the file
    # a list field (a collated batch) takes its first entry, as JAX's does
    _assert_same(ours({"scene": ["scene0"], "name": ["im1.jpg"]}),
                 theirs({"scene": ["scene0"], "name": ["im1.jpg"]}))
    with pytest.raises(KeyError):
        ours({"scene": "scene0", "name": "missing.jpg"})
    assert len(ours._files) == 1  # one handle per file
    ours.close()
    theirs.close()


def _write_port_cache(path: Path, rng, n_groups: int = 420) -> dict:
    items = {}
    with H5Writer(path) as f:
        for i in range(n_groups):
            name = f"img{i:04d}.jpg" if i % 4 else f"folder{i % 3}/img{i:04d}.jpg"
            n = 0 if i % 17 == 0 else int(rng.integers(1, 40))
            arrays = {"keypoints": rng.uniform(0, 500, (n, 2)).astype(np.float16),
                      "keypoint_scores": rng.random(n).astype(np.float32),
                      "descriptors": rng.normal(size=(n, 16)).astype(np.float16),
                      "depth_keypoints": rng.uniform(1, 9, n).astype(np.float16),
                      "valid_depth_keypoints": rng.random(n) > 0.5,
                      "count": np.int64(n), "order": np.arange(n, dtype=np.int32)}
            grp = f.create_group(name)
            for k, v in arrays.items():
                grp.create_dataset(k, data=v)
            items[name] = arrays
    return items


def test_port_writer_read_by_h5py_and_jax_cache_loader(tmp_path):
    items = _write_port_cache(tmp_path / "cache.h5", np.random.default_rng(1))
    top = {name.split("/")[0] for name in items}
    assert len(top) > 300  # more than 2 * 16 symbol nodes: a B-tree of two levels
    with h5py.File(tmp_path / "cache.h5", "r") as f:
        assert set(f.keys()) == top
        assert sorted(f.keys()) == list(f.keys())
        for name, arrays in items.items():
            grp = f[name]
            assert set(grp.keys()) == set(arrays)
            for k, v in arrays.items():
                got = grp[k][()]
                assert got.dtype == v.dtype and got.shape == v.shape, (name, k)
                np.testing.assert_array_equal(got, v)
    with H5File(tmp_path / "cache.h5") as f:
        assert f.keys() == sorted(top)
        for name, arrays in items.items():
            _assert_same({k: f[name][k] for k in f[name].keys()}, arrays)
    cfg = {"path": str(tmp_path / "cache.h5"), "padding_length": 32,
           "data_keys": ["keypoints", "keypoint_scores", "descriptors", "valid_depth_keypoints"]}
    ours, theirs = cache_loader.CacheLoader(cfg), jcl.CacheLoader(cfg)
    for name in list(items)[::7]:
        data = {"name": name, "scales": np.array([2.0, 0.5], np.float32)}
        _assert_same(ours(data), theirs(data))


def test_reader_opened_before_fork_serves_children(tmp_path):
    """An `H5File` opened (its tables read) before a fork reads the same
    arrays in each child: positioned reads share no file offset."""
    items = _write_port_cache(tmp_path / "cache.h5", np.random.default_rng(2), n_groups=40)
    names = list(items)
    f = H5File(tmp_path / "cache.h5")
    assert names[0] in f
    script = (
        "import os, sys, pickle, numpy as np\n"
        "from gluefactory_tpu_torch.data.hdf5 import H5File\n"
        "f = H5File(sys.argv[1]); names = sys.argv[2:]\n"
        "assert names[0] in f\n"
        "pids = []\n"
        "for w in range(3):\n"
        "    pid = os.fork()\n"
        "    if pid == 0:\n"
        "        ok = all(np.array_equal(f[n + '/order'], np.arange(len(f[n + '/order']))) "
        "for n in names[w::3] * 20)\n"
        "        os._exit(0 if ok else 1)\n"
        "    pids.append(pid)\n"
        "codes = [os.waitpid(p, 0)[1] for p in pids]\n"
        "g = pickle.loads(pickle.dumps(f))\n"
        "assert np.array_equal(g[names[1] + '/order'], f[names[1] + '/order'])\n"
        "print(codes); assert codes == [0, 0, 0], codes\n")
    res = subprocess.run([sys.executable, "-c", script, str(tmp_path / "cache.h5"), *names],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    f.close()


# -- the homography dataset with load_features ---------------------------

HCONF = {"train_size": 4, "val_size": 1, "source_size": [160, 120],
         "homography": {"patch_shape": [128, 96], "difficulty": 0.7, "max_angle": 45},
         "photometric": {"name": "identity"}, "seed": 3}


def _write_folder(folder: Path, n: int = 6) -> list:
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        size = (200, 150) if i % 2 else (120, 100)  # the small ones are upscaled
        img = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
        p = folder / ("nested" if i % 3 == 0 else "") / f"im{i}.png"
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def _homography_cache(path: Path, keys: list, rng) -> None:
    with h5py.File(path, "w") as f:
        for key in keys:
            n = 80
            grp = f.create_group(key)
            grp.create_dataset("keypoints", data=rng.uniform(0, 200, (n, 2)).astype(np.float16))
            grp.create_dataset("keypoint_scores", data=rng.random(n).astype(np.float32))
            grp.create_dataset("descriptors", data=rng.normal(size=(n, 8)).astype(np.float16))


@pytest.mark.parametrize("lf", [{}, {"thresh": 0.3}, {"max_num_keypoints": 20},
                                {"max_num_keypoints": 40, "force_num_keypoints": True}])
def test_transform_features_equals_jax(lf):
    rng = np.random.default_rng(7)
    features = {"keypoints": rng.uniform(-20, 180, (60, 2)).astype(np.float32),
                "keypoint_scores": rng.random(60).astype(np.float32),
                "descriptors": rng.normal(size=(60, 8)).astype(np.float32)}
    conf = {**HCONF, "synthetic_images": 6, "load_features": {"path": "unused.h5", **lf}}
    ours = HomographyDataset(conf).get_dataset("train")
    theirs = JaxHomographyDataset(conf).get_dataset("train")
    H = np.array([[0.9, 0.1, -5.0], [-0.05, 1.1, 8.0], [1e-4, -2e-4, 1.0]], np.float32)
    got = ours._transform_features(dict(features), H, (128, 96))
    want = theirs._transform_features(dict(features), H, (128, 96))
    _assert_same(got, want)
    assert 0 < len(got["keypoints"]) < 60 or lf.get("force_num_keypoints")


def test_homography_items_with_cache_equal_jax(tmp_path, monkeypatch):
    """A folder of images (two upscaled), a cache with each image under the
    key the export writes (its path relative to the folder) and, for the
    JAX dataset, also under the key it looks up (the absolute path): every
    view's image, homography and cache equal."""
    import gluefactory_tpu.data.homographies as jhom
    import gluefactory_tpu_torch.data.homographies as thom

    folder = tmp_path / "images"
    paths = _write_folder(folder)
    exported = [p.relative_to(folder).as_posix() for p in paths]
    jax_keys = [str(p) for p in paths]  # what the JAX dataset asks for
    assert not set(exported) & set(jax_keys)
    rng = np.random.default_rng(3)
    _homography_cache(tmp_path / "ours.h5", exported, rng)
    _homography_cache(tmp_path / "theirs.h5", exported, np.random.default_rng(3))
    with h5py.File(tmp_path / "theirs.h5", "a") as f:  # the same groups under JAX's keys
        for e, j in zip(exported, jax_keys):
            f[j] = f[e]
    for mod in (jhom, thom):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    lf = {"do": True, "max_num_keypoints": 30, "force_num_keypoints": True, "padding_length": None}
    conf = {**HCONF, "image_dir": str(folder), "glob": ["*.png"], "train_size": 5}
    ours = HomographyDataset({**conf, "load_features": {**lf, "path": str(tmp_path / "ours.h5")}})
    theirs = JaxHomographyDataset({**conf, "load_features": {**lf, "path": str(tmp_path / "theirs.h5")}})
    ours, theirs = ours.get_dataset("train"), theirs.get_dataset("train")
    sizes = set()
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        sizes.add(tuple(a["original_image_size"]))
        np.testing.assert_array_equal(a["H_0to1"], b["H_0to1"])
        for v in ("view0", "view1"):
            assert set(a[v]) == set(b[v]) == {"image", "image_size", "cache"}
            assert (np.abs(a[v]["image"] - b[v]["image"]) <= 2e-2).mean() >= 0.99
            _assert_same(a[v]["cache"], b[v]["cache"])
            assert a[v]["cache"]["keypoint_mask"].shape == (30,)
        key = ours.cache_key(i)
        assert key in exported and str(folder / key) in jax_keys
    assert len(sizes) == 2  # the small images were upscaled, their keypoints scaled with them
    with pytest.raises(KeyError):  # the JAX lookup's key is not what the export writes
        JaxHomographyDataset({**conf, "load_features": {**lf, "path": str(tmp_path / "ours.h5")}}
                             ).get_dataset("train")[0]


# -- the image folder and export_local_features --------------------------

def test_image_folder_equals_jax(tmp_path, monkeypatch):
    import gluefactory_tpu_torch.settings as tsettings

    paths = _write_folder(tmp_path / "imgs")
    for mod, attr in ((jif, "DATA_PATH"), (tsettings, "DATA_PATH")):
        monkeypatch.setattr(mod, attr, tmp_path)
    for images in ("imgs", [str(p) for p in paths[1:4]]):
        conf = {"images": images, "preprocessing": {"resize": 64}}
        ours = ImageFolder(conf).get_dataset("test")
        theirs = jif.ImageFolder(conf).get_dataset("test")
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a["name"] == b["name"] and a["idx"] == b["idx"]
            assert set(a) == set(b)
            for k in ("image", "scales", "image_size", "original_image_size"):
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)
        if images == "imgs":  # names relative to the folder
            assert {ours[i]["name"] for i in range(len(ours))} == {
                p.relative_to(tmp_path / "imgs").as_posix() for p in paths}


def test_export_local_features_cli(tmp_path):
    paths = _write_folder(tmp_path / "imgs", n=3)
    out = tmp_path / "feats.h5"
    env = {**os.environ, "GLUEFACTORY_DATA": str(tmp_path)}
    res = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.scripts.export_local_features",
                          "--image_dir", str(tmp_path / "imgs"), "--output", str(out),
                          "--num_keypoints", "32", "--resize", "96", "--as_half", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    names = sorted(p.relative_to(tmp_path / "imgs").as_posix() for p in paths)
    with h5py.File(out, "r") as f:
        groups = []
        f.visititems(lambda n, obj: groups.append(n) if "keypoints" in obj.attrs.keys() or (
            isinstance(obj, h5py.Group) and "keypoints" in obj) else None)
        assert sorted(groups) == names
        kpts = f[names[0]]["keypoints"][()]
        assert kpts.dtype == np.float16 and kpts.shape[1] == 2 and 0 < len(kpts) <= 32
        assert f[names[0]]["descriptors"].shape == (len(kpts), 256)
    loader = cache_loader.CacheLoader({"path": str(out), "padding_length": 32})
    item = loader({"name": names[-1]})
    assert item["keypoints"].shape == (32, 2) and item["keypoint_mask"].any()
    # DISK is ported: its 128-D descriptors; SIFT is not yet, and raises
    res = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.scripts.export_local_features",
                          "--image_dir", str(tmp_path / "imgs"), "--output", str(tmp_path / "x.h5"),
                          "--method", "disk", "--num_keypoints", "32", "--resize", "96", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    with h5py.File(tmp_path / "x.h5", "r") as f:
        assert f[names[0]]["descriptors"].shape[1] == 128
    res = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.scripts.export_local_features",
                          "--image_dir", str(tmp_path / "imgs"), "--output", str(tmp_path / "y.h5"),
                          "--method", "sift", "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "queue 1 item 5" in res.stderr
