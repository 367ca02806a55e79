"""Zero-shot evaluation benchmark (ZEB, the GIM pair lists) (counterpart of
`gluefactory_tpu/data/zeb.py`).

Layout under `DATA_PATH / root`: `<scene>/<subscene><sep><img0>-<img1>.txt`
(sep `-` or `_`), each with one line `name0 name1 overlap0 overlap1 K0(9)
K1(9) T_0to1(12|16)`, the images beside them as `<subscene><sep><img>.*`.
Scenes come from `scene_list` (a list, or a file under the root), else
every folder; `exclude_scenes` drops some; `min_overlap` / `max_overlap`
filter the pairs by the smaller of the two overlaps; `max_per_scene` draws
that many of a scene's pairs (sorted by name) with `RandomState(i)`, i the
scene's index in sorted order; `shuffle` permutes all pairs (sorted by
name) with `RandomState(seed)`; `check` parses a scene's first 900 pair
files when the dataset is built.

An item's `overlap` is the JAX package's value, `min(pair_data[1:3])` of
the line after its two names, that is min(overlap1, K0[0, 0]), while the
filter reads (overlap0, overlap1); see ROADMAP queue 3.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import settings
from .base_dataset import BaseDataset
from .geometry_io import scale_camera_dict
from .image_pairs import parse_camera, parse_relative_pose
from .preprocess import ImagePreprocessor, read_image


def read_pair_data(pairs_file: Path) -> list:
    with open(pairs_file) as f:
        return f.readlines()[0].rstrip().split(" ")


def parse_overlap(pair_data: list) -> tuple:
    if len(pair_data) < 2:
        raise ValueError(f"pair data {pair_data} has no overlap info")
    return float(pair_data[0]), float(pair_data[1])


def parse_pairs(pairs_file: Path):
    """(image path 0, image path 1, the line's fields after the names)."""
    pair_data = read_pair_data(pairs_file)
    img_name0, img_name1 = (n.split(".")[0] for n in pair_data[:2])
    subscene = pairs_file.stem.replace(f"{img_name0}-{img_name1}", "")
    subscene = subscene.replace(f"{img_name0}_{img_name1}", "")
    subscene, sep = subscene[:-1], subscene[-1]
    img_path0 = list(pairs_file.parent.glob(f"{subscene}{sep}{img_name0}.*"))[0]
    img_path1 = list(pairs_file.parent.glob(f"{subscene}{sep}{img_name1}.*"))[0]
    return img_path0, img_path1, pair_data[2:]


class _ZEBItems:
    def __init__(self, parent):
        self.parent = parent
        self.conf = parent.conf

    def __len__(self):
        return len(self.parent.items)

    def _read_view(self, path: Path) -> dict:
        data = self.parent.preprocessor(read_image(path))
        data["name"] = path.name
        return data

    def __getitem__(self, idx):
        pair_file = self.parent.items[idx]
        img_path0, img_path1, pair_data = parse_pairs(pair_file)
        data0, data1 = self._read_view(img_path0), self._read_view(img_path1)
        data0["camera"] = scale_camera_dict(parse_camera(pair_data[2:11]), data0["scales"])
        data1["camera"] = scale_camera_dict(parse_camera(pair_data[11:20]), data1["scales"])
        scene = pair_file.parent.name
        return {
            "view0": data0,
            "view1": data1,
            "T_0to1": parse_relative_pose(pair_data[20:]),
            "scene": scene,
            "name": scene + "/" + pair_file.stem,
            # the JAX package's value: pair_data already starts at overlap0
            "overlap": min(*parse_overlap(pair_data[1:3])),
            "idx": idx,
        }


class ZEBPairs(BaseDataset):
    default_conf = {
        "root": "zeb",
        "preprocessing": {},
        "scene_list": None,
        "exclude_scenes": None,
        "shuffle": False,
        "seed": 42,  # the shuffle's seed
        "max_per_scene": None,
        "min_overlap": 0.0,
        "max_overlap": 1.0,
        "check": False,  # parse the pair files when the dataset is built
    }

    def _init(self, conf):
        self.root = settings.DATA_PATH / conf.root
        if not self.root.exists():
            raise FileNotFoundError(f"ZEB root {self.root} not found")
        if isinstance(conf.scene_list, (list, tuple)):
            scenes = list(conf.scene_list)
        elif isinstance(conf.scene_list, str):
            scenes = (self.root / conf.scene_list).read_text().rstrip("\n").split("\n")
        else:
            scenes = [s.name for s in self.root.glob("*") if s.is_dir()]
        if conf.exclude_scenes is not None:
            scenes = [s for s in scenes if s not in conf.exclude_scenes]
        self.scenes = scenes
        self.items = []
        for i, scene in enumerate(sorted(scenes)):
            pair_files = list((self.root / scene).glob("*.txt"))
            if conf.check:
                for pair_file in pair_files[:900]:
                    parse_pairs(pair_file)
            if conf.min_overlap > 0.0 or conf.max_overlap < 1.0:
                overlaps = np.array([min(*parse_overlap(read_pair_data(p)[2:4])) for p in pair_files])
                valid = (overlaps >= conf.min_overlap) & (overlaps <= conf.max_overlap)
                pair_files = [pair_files[j] for j in np.where(valid)[0]]
            if conf.max_per_scene is not None and len(pair_files) > conf.max_per_scene:
                pair_files = sorted(pair_files, key=lambda x: x.stem)
                pair_files = list(np.random.RandomState(i).choice(pair_files, conf.max_per_scene,
                                                                   replace=False))
            self.items.extend(pair_files)
        if conf.shuffle:
            self.items = sorted(self.items, key=lambda x: x.stem)
            np.random.RandomState(conf.seed).shuffle(self.items)
        self.preprocessor = ImagePreprocessor(conf.preprocessing)

    def get_dataset(self, split):
        return _ZEBItems(self)
