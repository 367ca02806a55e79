"""MegaDepth for training and validation (counterpart of
`gluefactory_tpu/data/megadepth.py`), stage 2 of LightGlue's recipe.

Layout under `DATA_PATH / data_dir` (D2-Net's): `scene_info/<scene>.npz`
(`image_paths`, `depth_paths`, `poses`, `intrinsics`, `overlap_matrix`),
`Undistorted_SfM/<scene>/images/`, `depth_undistorted/<scene>/<stem>.h5`.
Depths are read by `data/hdf5.py` (numpy and zlib; no h5py).

Items are sampled per split as the JAX package samples them, with the same
numpy RNG calls in the same order (a fresh `RandomState(seed)` for each
scene and each draw): fixed pair lists for val / test, single views,
pairs binned by overlap over [min_overlap, max_overlap] (a bin with fewer
than twice its quota is dropped and the budget split over the others),
`[num_pos, num_neg]` negatives of zero overlap, triplets (`views: 3`), then
sorted by overlap or shuffled. `sample_new_items(seed)` resamples the
training pairs; the trainer calls it at each epoch with `seed + epoch`
(`train.dataset_callback_fn`). Views can be rotated by +-90 degrees
(`p_rotate`, training only) with their intrinsics and pose.

Cached features (`load_features.do`, the conf of `models/cache_loader.py`):
each view's group `name` of the scene's cache (`scripts/export_megadepth.py`
writes it), scaled into the processed image and, for a rotated view, its
keypoints rotated with it, as `data["cache"]`; the pipeline's
`allow_no_extract` then skips the extractor.

Scene lists: a file of `data_dir/scene_lists/` first, else this package's
copy of upstream's lists (`megadepth_scene_lists/`, written by
`scripts/make_scene_lists.py` for other corpora).

Lines (`detect_lines.do`, with `read_image`): the processed view's LSD
segments and wireframe junctions (`models/lines/wireframe.
precompute_wireframe`) under the seven `WIREFRAME_KEYS`, computed in the
loader's workers; a failed detection raises there.

The dataset visualizer waits with `visualization/`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import logger, settings
from ..models.cache_loader import CacheLoader
from ..models.lines.wireframe import precompute_wireframe
from ..utils.tools import fork_rng
from .base_dataset import BaseDataset
from .geometry_io import camera_dict_from_K, compose_pose, invert_pose
from .hdf5 import read_dataset
from .preprocess import ImagePreprocessor, read_image
from .utils import rotate_intrinsics, rotate_pose_inplane, scale_intrinsics

# upstream's split lists, copied with this package
PACKAGED_SCENE_LISTS = Path(__file__).parent / "megadepth_scene_lists"


def sample_n(data, num, seed=None):
    """At most `num` rows of `data`, drawn without replacement by a fresh
    `RandomState(seed)` (the same seed repeats across scenes)."""
    if len(data) > num:
        selected = np.random.RandomState(seed).choice(len(data), num, replace=False)
        return data[selected]
    return data


class MegaDepth(BaseDataset):
    default_conf = {
        # paths
        "data_dir": "megadepth/",
        "depth_subpath": "depth_undistorted/",
        "image_subpath": "Undistorted_SfM/",
        "info_dir": "scene_info/",
        "scene_lists_dir": "scene_lists/",
        # training
        "train_split": "train_scenes_clean.txt",
        "train_num_per_scene": 500,
        "val_split": "valid_scenes_clean.txt",
        "val_num_per_scene": None,
        "val_pairs": None,
        "test_split": "test_scenes_clean.txt",
        "test_num_per_scene": None,
        "test_pairs": None,
        # data sampling
        "views": 2,
        "min_overlap": 0.3,
        "max_overlap": 1.0,
        "num_overlap_bins": 1,
        "sort_by_overlap": False,
        "triplet_enforce_overlap": False,
        # image options
        "read_depth": True,
        "read_image": True,
        "grayscale": False,
        "preprocessing": {},
        "p_rotate": 0.0,
        "reseed": False,
        "seed": 0,
        # features from a cache
        "load_features": {"do": False, **CacheLoader.default_conf},
        "detect_lines": {"do": False, "max_num_lines": 250, "min_length": 15.0, "nms_radius": 3.0},
    }

    def _init(self, conf):
        self.root = settings.DATA_PATH / conf.data_dir
        if not self.root.exists():
            raise FileNotFoundError(f"MegaDepth not found at {self.root}")
        self._datasets = {}

    def get_dataset(self, split: str):
        if split not in self._datasets:
            self._datasets[split] = _MegaDepthItems(self.conf, split)
        return self._datasets[split]

    def sample_new_items(self, seed: int):
        """The training pairs drawn anew (the trainer's per-epoch hook)."""
        self.get_dataset("train").sample_new_items(seed)


class _MegaDepthItems:
    def __init__(self, conf, split, load_sample=True):
        self.conf = conf
        self.split = split
        self.root = settings.DATA_PATH / conf.data_dir
        self.scene_lists_path = self.root / conf.scene_lists_dir

        split_conf = conf[split + "_split"]
        if isinstance(split_conf, str):
            scenes = self._resolve_scene_list(split_conf).read_text().rstrip("\n").split("\n")
        elif isinstance(split_conf, (list, tuple)):
            scenes = list(split_conf)
        else:
            raise ValueError(f"unknown split conf {split_conf}")
        scenes = sorted(set(scenes))
        self.feature_loader = None
        if conf.load_features.do:
            self.feature_loader = CacheLoader(
                {k: v for k, v in conf.load_features.to_dict().items() if k != "do"})
        self.preprocessor = ImagePreprocessor(conf.preprocessing)

        self.images, self.depths, self.poses, self.intrinsics = {}, {}, {}, {}
        self.info_dir = self.root / conf.info_dir
        self.scenes = []
        for scene in scenes:
            path = self.info_dir / (scene + ".npz")
            try:
                info = np.load(str(path), allow_pickle=True)
            except Exception:
                logger.warning("Cannot load scene info for %s at %s", scene, path)
                continue
            self.images[scene] = info["image_paths"]
            self.depths[scene] = info["depth_paths"]
            self.poses[scene] = info["poses"]
            self.intrinsics[scene] = info["intrinsics"]
            self.scenes.append(scene)

        if load_sample:
            self.sample_new_items(conf.seed)
            assert len(self.items) > 0, "no MegaDepth items sampled"

    def _resolve_scene_list(self, filename: str) -> Path:
        for base in (self.scene_lists_path, PACKAGED_SCENE_LISTS):
            path = base / filename
            if path.exists():
                return path
        raise FileNotFoundError(
            f"scene list {filename} found neither under {self.scene_lists_path} "
            f"nor in the packaged lists {PACKAGED_SCENE_LISTS}; provide "
            f"data.{self.split}_split as an explicit list or add the file")

    # -- item sampling ---------------------------------------------------

    def _parse_num_per_scene(self):
        value = self.conf[self.split + "_num_per_scene"]
        return tuple(value) if isinstance(value, (list, tuple)) else (value, None)

    def _fixed_pair_items(self, pairs_file: str):
        """Items of a '<scene>/<im0> <scene>/<im1>' pair list (val / test)."""
        out = []
        for line in self._resolve_scene_list(pairs_file).read_text().rstrip("\n").split("\n"):
            names = line.split(" ")
            scene = names[0].split("/")[0]
            rel0, rel1 = (self.conf.image_subpath + n for n in names)
            out.append((scene, int(np.flatnonzero(self.images[scene] == rel0)[0]),
                        int(np.flatnonzero(self.images[scene] == rel1)[0]), 1.0))
        return out

    def _single_view_items(self, scene: str, num_pos, seed: int):
        usable = np.flatnonzero(
            (self.images[scene] != None) | (self.depths[scene] != None))  # noqa: E711
        if num_pos and len(usable) > num_pos:
            usable = np.random.RandomState(seed).choice(usable, num_pos, replace=False)
        return [(scene, int(i)) for i in usable]

    def _binned_pair_indices(self, mat: np.ndarray, num_pos: int, seed: int):
        """Pairs binned uniformly over [min_overlap, max_overlap]; a bin
        with fewer than twice its quota is dropped and the budget split
        over the bins left."""
        conf = self.conf
        edges = np.linspace(conf.min_overlap, conf.max_overlap, conf.num_overlap_bins + 1)
        by_bin = [np.argwhere((mat > lo) & (mat <= hi)) for lo, hi in zip(edges[:-1], edges[1:])]
        quota = num_pos // conf.num_overlap_bins
        full = [b for b in by_bin if len(b) >= quota * 2]
        share = num_pos // max(1, len(full))
        kept = [sample_n(b, share, seed) for b in full]
        return np.concatenate(kept, 0) if kept else np.zeros((0, 2), int)

    def _scene_pair_items(self, scene: str, num_pos, num_neg, seed: int):
        conf = self.conf
        info = np.load(str(self.info_dir / (scene + ".npz")), allow_pickle=True)
        valid = (self.images[scene] != None) & (self.depths[scene] != None)  # noqa: E711
        ind = np.flatnonzero(valid)
        mat = info["overlap_matrix"][valid][:, valid]
        if conf.views == 3:
            return self._sample_triplets(scene, ind, mat, num_pos, seed)
        if num_pos is not None:
            chosen = self._binned_pair_indices(mat, num_pos, seed)
        else:
            chosen = np.argwhere((mat > conf.min_overlap) & (mat <= conf.max_overlap))
        if num_neg is not None:
            negatives = sample_n(np.argwhere(mat <= 0.0), num_neg, seed)
            chosen = np.concatenate([chosen, negatives], 0)
        return [(scene, int(ind[i]), int(ind[j]), float(mat[i, j])) for i, j in chosen]

    def sample_new_items(self, seed: int):
        logger.info("Sampling new %s MegaDepth items with seed %d", self.split, seed)
        conf = self.conf
        num_pos, num_neg = self._parse_num_per_scene()
        if self.split != "train" and conf.get(self.split + "_pairs") is not None:
            self.items = self._fixed_pair_items(conf[self.split + "_pairs"])
        elif conf.views == 1:
            self.items = [item for scene in self.scenes
                          for item in self._single_view_items(scene, num_pos, seed)]
        else:
            self.items = [item for scene in self.scenes
                          for item in self._scene_pair_items(scene, num_pos, num_neg, seed)]
        if conf.views == 2 and conf.sort_by_overlap:
            self.items.sort(key=lambda it: it[-1], reverse=True)
        else:
            np.random.RandomState(seed).shuffle(self.items)

    def _sample_triplets(self, scene, ind, mat, num_pos, seed):
        """Pairs of overlapping views, then a third view overlapping either
        (or, with `triplet_enforce_overlap`, both)."""
        conf = self.conf
        good = (mat > conf.min_overlap) & (mat <= conf.max_overlap)
        pairs = np.stack(np.where(good), -1)
        pairs = sample_n(pairs, num_pos or len(pairs), seed)
        rng = np.random.RandomState(seed)
        items = []
        for i, j in pairs:
            if conf.triplet_enforce_overlap:
                k_candidates = np.where(good[i] & good[j])[0]
            else:
                k_candidates = np.where(good[i] | good[j])[0]
            k_candidates = k_candidates[(k_candidates != i) & (k_candidates != j)]
            if len(k_candidates) == 0:
                continue
            k = rng.choice(k_candidates)
            items.append((scene, int(ind[i]), int(ind[j]), int(ind[k]),
                          float(mat[i, j]), float(mat[i, k]), float(mat[j, k])))
        return items

    # -- reading ---------------------------------------------------------

    def _read_view(self, scene, idx, rng) -> dict:
        conf = self.conf
        path = self.root / self.images[scene][idx]
        K = self.intrinsics[scene][idx].astype(np.float32, copy=False)
        T = self.poses[scene][idx].astype(np.float32, copy=False)

        if conf.read_image:
            img = read_image(path, conf.grayscale)
        else:
            from PIL import Image

            with Image.open(path) as im:
                size = im.size[::-1]
            img = np.zeros((size[0], size[1], 1 if conf.grayscale else 3), np.float32)

        depth = None
        if conf.read_depth:
            depth_path = self.root / conf.depth_subpath / scene / (path.stem + ".h5")
            depth = read_dataset(depth_path, "/depth").astype(np.float32)

        # +-90 degree rotation: the image, the depth, K and the pose
        k_rot = 0
        if conf.p_rotate > 0.0 and self.split == "train" and rng.random() < conf.p_rotate:
            k_rot = int(rng.choice(2)) * 2 - 1  # -1 or +1 (cw / ccw)
            pre_shape = img.shape[:2]  # rotate_intrinsics takes the pre-rotation (h, w)
            img = np.rot90(img, k=-k_rot, axes=(0, 1)).copy()
            if depth is not None:
                depth = np.rot90(depth, k=-k_rot, axes=(0, 1)).copy()
            K = rotate_intrinsics(K, pre_shape, k_rot % 4)
            T = rotate_pose_inplane(T, k_rot % 4)

        data = self.preprocessor(img)
        if depth is not None:
            dproc = ImagePreprocessor(dict(self.preprocessor.conf.to_dict(), interpolation="nearest",
                                           antialias=False))(depth[..., None])
            data["depth"] = dproc["image"][..., 0]
        K = scale_intrinsics(K, data["scales"])
        data["name"] = path.name
        data["scene"] = scene
        data["T_w2cam"] = T
        data["camera"] = camera_dict_from_K(K, data["image_size"][0], data["image_size"][1])

        dl = conf.detect_lines
        if dl.do and conf.read_image:
            # the processed (H, W, C) image: resized, square-padded, rotated
            data.update(precompute_wireframe(data["image"], dl.max_num_lines, dl.min_length,
                                             dl.nms_radius))

        if self.feature_loader is not None:
            features = self.feature_loader({**data, "scene": scene, "name": path.name})
            if k_rot != 0 and "keypoints" in features:
                # the cache holds the unrotated image's keypoints
                kpts = features["keypoints"].copy()
                x, y = kpts[..., 0].copy(), kpts[..., 1].copy()
                w, h = data["image_size"]
                if k_rot == 1:
                    kpts[..., 0], kpts[..., 1] = w - y, x
                else:
                    kpts[..., 0], kpts[..., 1] = y, h - x
                features["keypoints"] = kpts
            data["cache"] = features
        return data

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        if self.conf.reseed:
            with fork_rng(self.conf.seed + idx):
                return self.getitem(idx)
        return self.getitem(idx)

    def getitem(self, idx):
        conf = self.conf
        rng = np.random.default_rng((conf.seed, idx))
        if conf.views == 3:
            scene, idx0, idx1, idx2, ov01, ov02, ov12 = self.items[idx]
            views = [self._read_view(scene, i, rng) for i in (idx0, idx1, idx2)]
            data = {f"view{i}": v for i, v in enumerate(views)}
            for a, b, key in ((0, 1, "0to1"), (0, 2, "0to2"), (1, 2, "1to2")):
                data[f"T_{key}"] = compose_pose(data[f"view{b}"]["T_w2cam"],
                                                invert_pose(data[f"view{a}"]["T_w2cam"]))
            data["overlap_0to1"] = ov01
            data["overlap_0to2"] = ov02
            data["overlap_1to2"] = ov12
            data["name"] = f"{scene}/{views[0]['name']}_{views[1]['name']}_{views[2]['name']}"
        elif conf.views == 2:
            if isinstance(idx, tuple):
                scene, idx0, idx1, overlap = idx
            else:
                scene, idx0, idx1, overlap = self.items[idx]
            data0 = self._read_view(scene, idx0, rng)
            data1 = self._read_view(scene, idx1, rng)
            data = {"view0": data0, "view1": data1}
            data["T_0to1"] = compose_pose(data1["T_w2cam"], invert_pose(data0["T_w2cam"]))
            data["overlap_0to1"] = overlap
            data["name"] = f"{scene}/{data0['name']}_{data1['name']}"
        else:
            scene, idx0 = self.items[idx]
            data = self._read_view(scene, idx0, rng)
            data["name"] = f"{scene}/{data['name']}"
        data["scene"] = scene
        data["idx"] = idx if isinstance(idx, int) else 0
        return data
