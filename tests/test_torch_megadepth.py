"""The port's MegaDepth dataset (`gluefactory_tpu_torch/data/megadepth.py`)
against the JAX package's on a fabricated D2-Net layout of four scenes
(JPEGs through cv2, HDF5 depths through h5py, `scene_info/*.npz` with
object arrays and a missing view): the sampled items equal for every
sampling mode over seeds 0-3, and every array of `getitem` bit-equal
(images, depths, cameras, poses, overlaps), rotated views and `reseed`
included. Also the camera updates, the packaged scene lists, the
RNG-state helpers, `scripts/make_scene_lists.py` and the procedural
scenes of `scripts_dev/posed_scenes.write_megadepth_scene`."""

import random
import subprocess
import sys
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

import gluefactory_tpu.data.megadepth as jmd
import gluefactory_tpu_torch.settings as tsettings
from gluefactory_tpu.data import get_dataset as jax_get_dataset
from gluefactory_tpu.data import utils as jutils
from gluefactory_tpu.data.homographies import generate_synthetic_image
from gluefactory_tpu.scripts import make_scene_lists as jscript
from gluefactory_tpu_torch.data import get_dataset, megadepth
from gluefactory_tpu_torch.data import utils as tutils
from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
from gluefactory_tpu_torch.data.hdf5 import read_dataset
from gluefactory_tpu_torch.scripts import make_scene_lists as tscript
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene
from gluefactory_tpu_torch.utils import tools

SCENES = ["0001", "0002", "0003", "0004"]
N_VIEWS = 8
SIZES = {"0001": (64, 48), "0002": (48, 64), "0003": (64, 48), "0004": (56, 40)}


def _overlaps(rng, n, scene):
    """Overlaps spread over every bin, zeros for negatives; scene 0003 has
    almost none above 0.5 (a thin bin there)."""
    m = rng.uniform(0.0, 0.95, (n, n))
    if scene == "0003":
        m = np.minimum(m, 0.5) - 0.01 * rng.random((n, n))
        m[0, 1] = 0.6
    m[rng.random((n, n)) < 0.2] = 0.0
    np.fill_diagonal(m, 1.0)
    return m


@pytest.fixture(scope="module")
def md_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    base = root / "megadepth"
    (base / "scene_info").mkdir(parents=True)
    (base / "scene_lists").mkdir()
    rng = np.random.default_rng(0)
    for s, scene in enumerate(SCENES):
        w, h = SIZES[scene]
        (base / "Undistorted_SfM" / scene / "images").mkdir(parents=True)
        (base / "depth_undistorted" / scene).mkdir(parents=True)
        images, depths, poses, Ks = [], [], [], []
        for i in range(N_VIEWS):
            img = (generate_synthetic_image(100 * s + i, (w, h)) * 255).astype(np.uint8)
            rel = f"Undistorted_SfM/{scene}/images/im{i}.jpg"
            cv2.imwrite(str(base / rel), img[..., ::-1])
            depth = rng.uniform(2, 8, (h, w)).astype(np.float32)
            depth[rng.random((h, w)) < 0.1] = 0
            with h5py.File(base / "depth_undistorted" / scene / f"im{i}.h5", "w") as f:
                f.create_dataset("/depth", data=depth)
            images.append(rel)
            depths.append(f"depth_undistorted/{scene}/im{i}.h5")
            R = cv2.Rodrigues(rng.normal(size=3) * 0.1)[0]
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, rng.normal(size=3)
            poses.append(T)
            Ks.append(np.array([[60.0 + i, 0, w / 2 + 2.7], [0, 58.0, h / 2 - 1.9], [0, 0, 1]]))
        if scene == "0004":  # a view without depth, as in MegaDepth's scene_info
            depths[3] = None
        np.savez(base / "scene_info" / f"{scene}.npz", image_paths=np.array(images, object),
                 depth_paths=np.array(depths, object), poses=np.array(poses),
                 intrinsics=np.array(Ks), overlap_matrix=_overlaps(rng, N_VIEWS, scene))
    (base / "scene_lists" / "train_scenes_clean.txt").write_text("0001\n0002\n0003\n0004\n")
    (base / "scene_lists" / "valid_scenes_clean.txt").write_text("0002\n")
    (base / "scene_lists" / "valid_pairs.txt").write_text(
        "0002/images/im0.jpg 0002/images/im5.jpg\n0002/images/im3.jpg 0002/images/im1.jpg\n"
        "0001/images/im7.jpg 0001/images/im2.jpg\n")
    return root


@pytest.fixture()
def both(md_root, monkeypatch):
    monkeypatch.setattr(jmd, "DATA_PATH", md_root)
    monkeypatch.setattr(tsettings, "DATA_PATH", md_root)

    def make(conf, split="train"):
        return (jax_get_dataset("megadepth")(conf).get_dataset(split),
                get_dataset("megadepth")(conf).get_dataset(split))

    return make


SAMPLING = {
    "pairs_1bin": {"train_num_per_scene": 6},
    "pairs_3bins": {"train_num_per_scene": 9, "min_overlap": 0.1, "max_overlap": 0.7,
                    "num_overlap_bins": 3},
    "pairs_3bins_thin": {"train_num_per_scene": 12, "min_overlap": 0.1, "max_overlap": 0.7,
                         "num_overlap_bins": 3},
    "pairs_all": {"train_num_per_scene": None},
    "pairs_neg": {"train_num_per_scene": [5, 3], "num_overlap_bins": 2},
    "sort_by_overlap": {"train_num_per_scene": 7, "sort_by_overlap": True},
    "views1": {"views": 1, "train_num_per_scene": 5},
    "views3": {"views": 3, "train_num_per_scene": 6},
    "views3_enforce": {"views": 3, "train_num_per_scene": 6, "triplet_enforce_overlap": True,
                       "min_overlap": 0.2},
}


@pytest.mark.parametrize("name", list(SAMPLING))
def test_train_items_equal_jax(both, name):
    """`sample_new_items` over seeds 0-3 gives the JAX package's items
    (the same RNG calls in the same order)."""
    jax_items, items = both({"train_split": "train_scenes_clean.txt", **SAMPLING[name]})
    assert jax_items.items == items.items and len(items.items) > 0
    seen = []
    for seed in range(4):
        jax_items.sample_new_items(seed)
        items.sample_new_items(seed)
        assert jax_items.items == items.items
        seen.append(list(items.items))
    if name not in ("pairs_all", "sort_by_overlap"):
        assert seen[1] != seen[2]


def test_thin_bins_are_dropped(both):
    """Scene 0003 has one pair above 0.5: its third bin is dropped and the
    budget split over the other two."""
    _, items = both({"train_split": ["0003"], **SAMPLING["pairs_3bins_thin"]})
    overlaps = [it[-1] for it in items.items]
    assert len(overlaps) == 12 and max(overlaps) <= 0.5


def test_val_items_equal_jax(both):
    """Fixed val pairs from the data dir's list, and val scenes sampled."""
    jax_items, items = both({"val_pairs": "valid_pairs.txt", "val_split": ["0001", "0002"]}, "val")
    assert jax_items.items == items.items and len(items.items) == 3
    jax_items, items = both({"val_num_per_scene": 4, "num_overlap_bins": 1}, "val")
    assert jax_items.items == items.items and {it[0] for it in items.items} == {"0002"}


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


GETITEM = {
    "views2": {"train_num_per_scene": 6},
    "views2_rotate": {"train_num_per_scene": 6, "p_rotate": 1.0},
    "views2_rotate_reseed_pad": {"train_num_per_scene": 6, "p_rotate": 0.5, "reseed": True,
                                 "preprocessing": {"resize": 40, "side": "long", "square_pad": True}},
    "views3_rotate": {"views": 3, "train_num_per_scene": 4, "p_rotate": 1.0,
                      "preprocessing": {"resize": 32, "side": "short"}},
    "views1_grey": {"views": 1, "train_num_per_scene": 3, "grayscale": True},
    "no_image": {"train_num_per_scene": 3, "read_image": False},
}


@pytest.mark.parametrize("name", list(GETITEM))
def test_getitem_equals_jax(both, name):
    """Every array of every item bit-equal to the JAX package's: the JPEG
    read, the `area` resize and square padding, the h5 depth and its
    `nearest` resize, the rotated image, depth, intrinsics and pose, the
    camera dict, `T_0to1` (and the triplet's poses), the overlaps."""
    jax_items, items = both({"train_split": "train_scenes_clean.txt", **GETITEM[name]})
    assert jax_items.items == items.items
    for i in range(len(items)):
        _assert_same(jax_items[i], items[i], f"item {i}")


def test_rotation_flips_the_aspect(both):
    _, items = both({"train_split": ["0001"], "train_num_per_scene": 4, "p_rotate": 1.0})
    for i in range(len(items)):
        item = items[i]
        for v in ("view0", "view1"):
            assert item[v]["image"].shape[:2] == (64, 48)
            assert item[v]["depth"].shape == (64, 48)


def test_batches_through_the_loader(both, md_root):
    """The port's loader collates items into a batch that `prepare_batch`
    turns into cameras and poses."""
    conf = {"train_split": ["0001", "0003"], "train_num_per_scene": 4, "batch_size": 3,
            "preprocessing": {"resize": 64, "side": "long", "square_pad": True}}
    dataset = get_dataset("megadepth")(conf)
    batch = prepare_batch(next(iter(dataset.get_data_loader("train"))), "cpu")
    assert batch["view0"]["image"].shape == (3, 64, 64, 3)
    assert batch["view0"]["depth"].shape == (3, 64, 64)
    assert batch["view0"]["camera"].size.shape == (3, 2)
    assert batch["T_0to1"].R.shape == (3, 3, 3)
    assert batch["overlap_0to1"].dtype == torch.float32


def test_not_ported_options_raise(both):
    """`detect_lines` raises; `load_features` is ported: both packages
    build their cache loader from it (`tests/test_torch_cached_features.py`
    holds the items)."""
    jax_items, items = both({"train_split": ["0001"], "train_num_per_scene": 2,
                             "load_features": {"do": True, "path": "c/{scene}.h5"}})
    assert items.feature_loader.conf.path == jax_items.feature_loader.conf.path == "c/{scene}.h5"
    with pytest.raises(NotImplementedError, match="wireframe"):
        get_dataset("megadepth")({"detect_lines": {"do": True}})


def test_scene_lists_are_upstreams():
    jax_dir = Path(jmd.__file__).parent / "megadepth_scene_lists"
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in megadepth.PACKAGED_SCENE_LISTS.iterdir())
    assert len(names) == 6
    for n in names:
        assert (megadepth.PACKAGED_SCENE_LISTS / n).read_bytes() == (jax_dir / n).read_bytes(), n


def test_packaged_list_is_the_fallback(both, md_root):
    """A list absent from the data dir resolves to the packaged one."""
    _, items = both({"train_split": ["0001"], "train_num_per_scene": 2})
    assert items._resolve_scene_list("valid_pairs.txt").parent == md_root / "megadepth" / "scene_lists"
    got = items._resolve_scene_list("test_scenes_clean.txt")
    assert got == megadepth.PACKAGED_SCENE_LISTS / "test_scenes_clean.txt"
    with pytest.raises(FileNotFoundError):
        items._resolve_scene_list("nothing.txt")


@pytest.mark.parametrize("rot", [0, 1, 2, 3, -1])
def test_camera_updates_equal_jax(rot):
    rng = np.random.default_rng(rot + 5)
    K = np.array([[50.0, 0, 5.3], [0, 40.0, 7.1], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = cv2.Rodrigues(rng.normal(size=3) * 0.3)[0]
    T[:3, 3] = rng.normal(size=3)
    for got, want in ((tutils.rotate_intrinsics(K, (10, 14), rot), jutils.rotate_intrinsics(K, (10, 14), rot)),
                      (tutils.rotate_pose_inplane(T, rot), jutils.rotate_pose_inplane(T, rot)),
                      (tutils.scale_intrinsics(K, (0.5, 0.25)), jutils.scale_intrinsics(K, (0.5, 0.25)))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_random_state_helpers():
    random.seed(3)
    np.random.seed(3)
    torch.manual_seed(3)
    state = tools.get_random_state()
    a = (random.random(), np.random.rand(), torch.rand(1))
    with tools.fork_rng(7):
        inner = (random.random(), np.random.rand())
    tools.set_random_state(state)
    b = (random.random(), np.random.rand(), torch.rand(1))
    assert a[:2] == b[:2] and torch.equal(a[2], b[2])
    random.seed(7)
    np.random.seed(7)
    assert inner == (random.random(), np.random.rand())


def test_make_scene_lists_equals_jax(tmp_path, monkeypatch):
    scenes = ["0015", "0022", "0100", "0101", "0200", "5001", "0042", "1007"]
    out = {}
    for name, mod in (("jax", jscript), ("port", tscript)):
        data = tmp_path / name
        (data / "megadepth" / "scene_info").mkdir(parents=True)
        for s in scenes:
            (data / "megadepth" / "scene_info" / f"{s}.npz").write_bytes(b"")
        args = ["--val_fraction", "0.3"]
        if mod is jscript:
            monkeypatch.setattr(jscript, "DATA_PATH", data)
            monkeypatch.setattr(sys, "argv", ["make_scene_lists", *args])
            jscript.main()
        else:
            monkeypatch.setattr(tsettings, "DATA_PATH", data)
            tscript.main(args)
        out[name] = {p.name: p.read_bytes() for p in (data / "megadepth" / "scene_lists").iterdir()}
    assert out["jax"] == out["port"] and len(out["port"]) == 3
    assert out["port"]["test_scenes_clean.txt"] == b"0015\n0022\n"
    assert out["port"]["valid_scenes_clean.txt"] != b"\n"


def test_procedural_scene(tmp_path, monkeypatch):
    """`write_megadepth_scene`: the layout the dataset reads, depths read
    back equal to what was written, an overlap matrix that is symmetric
    with a unit diagonal and fills the stage-2 config's three bins."""
    import hashlib

    res = write_megadepth_scene(tmp_path / "megadepth", "s0", n_views=12, size=(160, 120), seed=0)
    info = np.load(tmp_path / "megadepth" / "scene_info" / "s0.npz", allow_pickle=True)
    assert list(info["image_paths"]) == res["image_paths"]
    assert info["poses"].shape == (12, 4, 4) and info["intrinsics"].shape == (12, 3, 3)
    for rel, digest in zip(info["depth_paths"], res["depth_sha256"]):
        depth = read_dataset(tmp_path / "megadepth" / rel, "/depth")
        assert depth.dtype == np.float32 and depth.shape == (120, 160)
        assert hashlib.sha256(depth.tobytes()).hexdigest() == digest
        assert (depth > 0).mean() > 0.5
    m = info["overlap_matrix"]
    np.testing.assert_array_equal(m, m.T)
    np.testing.assert_array_equal(np.diag(m), 1.0)
    upper = m[np.triu_indices(12, 1)]
    counts = [int(((upper > lo) & (upper <= hi)).sum()) for lo, hi in ((0.1, 0.3), (0.3, 0.5), (0.5, 0.7))]
    assert min(counts) >= 8, counts
    monkeypatch.setattr(tsettings, "DATA_PATH", tmp_path)
    items = get_dataset("megadepth")({"train_split": ["s0"], "train_num_per_scene": 24,
                                      "min_overlap": 0.1, "max_overlap": 0.7,
                                      "num_overlap_bins": 3}).get_dataset("train")
    assert len(items) == 24
    item = items[0]
    assert item["view0"]["image"].shape == (120, 160, 3)
    assert (item["view0"]["depth"] > 0).any()


def test_procedural_scene_in_processes(tmp_path):
    """The writer's process pool, forked after torch's OpenMP pool has run,
    writes the same files as one process (in a process of its own without
    JAX, with a time limit, so that a hang fails the test: a child that
    keeps torch's threads hangs in its first parallel region at this size)."""
    code = f"""
import numpy as np, torch
from pathlib import Path
from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scene
torch.ones(1 << 22).exp().sum()  # torch's OpenMP pool runs here
out = []
for workers in (1, 2):
    root = Path({str(tmp_path)!r}) / f"w{{workers}}"
    res = write_megadepth_scene(root, "s0", n_views=4, size=(160, 120), seed=3, workers=workers)
    info = np.load(root / "scene_info" / "s0.npz", allow_pickle=True)
    out.append((res["depth_sha256"], [(root / p).read_bytes() for p in res["image_paths"]],
                info["overlap_matrix"].tobytes()))
assert out[0] == out[1]
print("same")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "same", res.stdout + res.stderr
