"""Posed-image benchmark dataset (counterpart of
`gluefactory_tpu/data/posed_images.py`), MegaDepth-1500's.

Layout under `DATA_PATH / root`: `<scene>/{<image_dir>/, <depth_dir>/,
views.txt, pairs.txt}`. A views.txt line is `name R(9) t(3) MODEL width
height params...` (the world-to-camera pose and the COLMAP camera); a
pairs.txt line names the views of one item (`name0 name1 [...]`). Each item
holds its views (image, camera scaled with the image, `T_w2cam`, and with
`depth_dir` the depth resized by `nearest` and `valid_depth`) and
`T_0to{i}`. Depths are 16-bit PNGs in 1/256 units (`depth_format: png`,
read through Pillow) or HDF5 files (`h5`, their `/depth` dataset read by
`data/hdf5.py`, without h5py).
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np

from .. import settings
from .base_dataset import BaseDataset
from .geometry_io import (camera_dict_from_colmap, compose_pose, invert_pose, pose_matrix_from_Rt,
                          scale_camera_dict)
from .hdf5 import read_dataset
from .preprocess import ImagePreprocessor, read_image


def names_to_pair(name0: str, name1: str, separator: str = "/") -> str:
    return separator.join((name0.replace("/", "-"), name1.replace("/", "-")))


def parse_pose_camera(fields: list):
    """(T_w2cam 4 x 4, camera dict) of a views.txt line's fields after the
    name."""
    R = np.array(fields[:9], np.float32).reshape(3, 3)
    t = np.array(fields[9:12], np.float32)
    camera = camera_dict_from_colmap(fields[12], int(fields[13]), int(fields[14]),
                                     [float(x) for x in fields[15:]])
    return pose_matrix_from_Rt(R, t), camera


def _read_png_depth(path: Path) -> np.ndarray:
    """A PNG's samples as `cv2.imread(IMREAD_ANYDEPTH)` gives them: 16-bit
    samples whole, 8-bit ones as they are, colour as cv2's grey."""
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError("reading PNG depth maps needs Pillow (PIL), which is not installed") from e
    from .preprocess import _rgb2gray

    try:
        with Image.open(path) as im:
            im = ImageOps.exif_transpose(im)
            if im.mode in ("I;16", "I;16B", "I;16L", "I"):
                return np.clip(np.asarray(im), 0, 65535).astype(np.uint16)
            if im.mode == "L":
                return np.asarray(im)
            return _rgb2gray(np.asarray(im.convert("RGB")), "PNG")[..., 0]
    except (OSError, ValueError, SyntaxError) as e:
        raise IOError(f"could not read depth {path}: {e}") from e


def load_depth(depth_path, dformat: str) -> np.ndarray:
    """A depth map as float32 (h, w): `png` in 1/256 units, `h5` its
    `/depth` dataset."""
    if dformat == "png":
        return _read_png_depth(Path(depth_path)).astype(np.float32) / 256.0
    if dformat == "h5":
        return read_dataset(depth_path, "/depth").astype(np.float32)
    raise ValueError(dformat)


class _PosedItems:
    def __init__(self, parent):
        self.parent = parent
        self.conf = parent.conf

    def __len__(self):
        return len(self.parent.items)

    def _read_view(self, scene, name) -> dict:
        parent = self.parent
        T_w2cam, camera = parse_pose_camera(parent.views[scene][name])
        data = parent.preprocessor(read_image(parent.get_image_path(scene, name)))
        data["T_w2cam"] = T_w2cam
        data["camera"] = scale_camera_dict(camera, data["scales"])
        data["name"] = name
        if self.conf.depth_dir:
            depth = load_depth(parent.get_depth_path(scene, name), self.conf.depth_format)
            dproc = ImagePreprocessor(dict(parent.preprocessor.conf.to_dict(),
                                           interpolation="nearest", antialias=False))(depth[..., None])
            data["depth"] = dproc["image"][..., 0]
            data["valid_depth"] = (data["depth"] > 0).astype(np.float32)
        if self.conf.extra_data:
            data.update(zip(self.conf.extra_keys, parent.extra_data[scene][name]))
        return data

    def __getitem__(self, idx):
        scene, *image_names = self.parent.items[idx]
        data = {f"view{i}": self._read_view(scene, n) for i, n in enumerate(image_names)}
        data["name"] = "/".join(n.replace("/", "-") for n in image_names)
        data["scene"] = scene
        data["idx"] = idx
        for i in range(1, len(image_names)):
            data[f"T_0to{i}"] = compose_pose(data[f"view{i}"]["T_w2cam"],
                                             invert_pose(data["view0"]["T_w2cam"]))
        return data


class PosedImageDataset(BaseDataset):
    default_conf = {
        "root": "???",
        "image_dir": "{scene}/images",
        "depth_dir": None,
        "views": "{scene}/views.txt",
        "view_groups": "{scene}/pairs.txt",
        "depth_format": "h5",
        "scene_list": None,
        # per-scene side data: lines `name v1 v2 ...` (literal-evaluated,
        # `#` lines skipped), merged into each view as zip(extra_keys, vs)
        "extra_data": None,
        "extra_keys": [],
        "preprocessing": {},
    }

    def get_image_path(self, scene, img_name):
        return self.root / self.conf.image_dir.format(scene=scene) / img_name

    def get_depth_path(self, scene, img_name):
        depth_name = f"{img_name.split('.')[0]}.{self.conf.depth_format}"
        return self.root / self.conf.depth_dir.format(scene=scene) / depth_name

    def _init(self, conf):
        self.root = settings.DATA_PATH / conf.root if conf.root != "" else settings.DATA_PATH
        if not self.root.exists():
            raise FileNotFoundError(f"posed-images root {self.root} not found")
        if isinstance(conf.scene_list, (list, tuple)):
            self.scenes = list(conf.scene_list)
        elif isinstance(conf.scene_list, str):
            self.scenes = (self.root / conf.scene_list).read_text().rstrip("\n").split("\n")
        else:
            self.scenes = [s.name for s in self.root.glob("*") if s.is_dir()]
        self.views, self.extra_data, self.items = {}, {}, []
        for scene in self.scenes:
            with open(self.root / conf.views.format(scene=scene)) as f:
                self.views[scene] = {line.rstrip().split(" ")[0]: line.rstrip().split(" ")[1:]
                                     for line in f}
            if conf.extra_data:
                lines = (self.root / conf.extra_data.format(scene=scene)).read_text()
                self.extra_data[scene] = {
                    line.split(" ")[0]: [ast.literal_eval(x) for x in line.rstrip().split(" ")[1:]]
                    for line in lines.rstrip("\n").split("\n") if not line.startswith("#")}
                unknown = set(self.extra_data[scene]) - set(self.views[scene])
                if unknown:
                    raise ValueError(f"extra data of scene {scene} names unknown views {unknown}")
            if conf.view_groups:
                groups = (self.root / conf.view_groups.format(scene=scene)).read_text()
                self.items += [[scene] + g.split(" ") for g in groups.rstrip("\n").split("\n")]
            else:
                self.items += [[scene, name] for name in self.views[scene]]
        self.preprocessor = ImagePreprocessor(conf.preprocessing)

    def get_dataset(self, split):
        return _PosedItems(self)


def main(argv=None):
    """Write a grid of the first pairs' views with their depths over them
    (MegaDepth-1500's layout under DATA_PATH by default; dotlist overrides
    of the dataset's conf)."""
    import argparse

    from ..core.config import from_dotlist, merge
    from ..visualization.viz2d import save_image_grid

    parser = argparse.ArgumentParser()
    parser.add_argument("--num_items", type=int, default=4)
    parser.add_argument("--dpi", type=int, default=100)
    parser.add_argument("--out", type=str, default="posed_images_samples.png")
    parser.add_argument("dotlist", nargs="*")
    args = parser.parse_intermixed_args(argv)
    conf = {"root": "megadepth1500", "depth_dir": "{scene}/depths",
            "preprocessing": {"resize": 1600, "side": "long", "interpolation": "area",
                              "antialias": False},
            "num_workers": 0, "batch_size": 1}
    ds = PosedImageDataset(merge(conf, from_dotlist(args.dotlist))).get_dataset("test")
    images, depths = [], []
    for i in range(min(args.num_items, len(ds))):
        data = ds[i]
        views = [data[k] for k in sorted(data) if k.startswith("view")]
        images.append([v["image"] for v in views])
        depths.append([v.get("depth") for v in views])
    save_image_grid(args.out, images, depths, dpi=args.dpi)


if __name__ == "__main__":
    main()
