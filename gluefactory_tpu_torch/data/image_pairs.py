"""Image pairs listed in a text file (counterpart of
`gluefactory_tpu/data/image_pairs.py`), ScanNet-1500's.

A line of the pairs file is one of
  `name0 name1`                        (extra_data None)
  `name0 name1 K0(9) K1(9) T(12|16)`   (extra_data relative_pose)
  `name0 name1 H(9)`                   (extra_data homography)
with the image names relative to `DATA_PATH / root`. The cameras are scaled
with the images; the homography is moved into the processed images' pixels.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import settings
from .base_dataset import BaseDataset
from .geometry_io import camera_dict_from_K, scale_camera_dict
from .posed_images import names_to_pair
from .preprocess import ImagePreprocessor, read_image


def parse_camera(elems) -> dict:
    return camera_dict_from_K(np.array([float(x) for x in elems[:9]]).reshape(3, 3))


def parse_relative_pose(elems) -> np.ndarray:
    vals = [float(x) for x in elems]
    if len(vals) == 12:
        T = np.eye(4, dtype=np.float32)
        T[:3] = np.array(vals).reshape(3, 4)
        return T
    if len(vals) == 16:
        return np.array(vals, np.float32).reshape(4, 4)
    raise ValueError(f"cannot interpret pose of {len(vals)} values")


class _PairItems:
    def __init__(self, parent):
        self.parent = parent
        self.conf = parent.conf

    def __len__(self):
        return len(self.parent.items)

    def _read_view(self, name):
        return self.parent.preprocessor(read_image(settings.DATA_PATH / self.conf.root / name))

    def __getitem__(self, idx):
        pair_data = self.parent.items[idx].split(" ")
        name0, name1 = pair_data[:2]
        data0, data1 = self._read_view(name0), self._read_view(name1)
        data = {"view0": data0, "view1": data1}
        if self.conf.extra_data == "relative_pose":
            data0["camera"] = scale_camera_dict(parse_camera(pair_data[2:11]), data0["scales"])
            data1["camera"] = scale_camera_dict(parse_camera(pair_data[11:20]), data1["scales"])
            data["T_0to1"] = parse_relative_pose(pair_data[20:])
        elif self.conf.extra_data == "homography":
            H = np.array([float(x) for x in pair_data[2:11]]).reshape(3, 3)
            data["H_0to1"] = (data1["transform"] @ H @ np.linalg.inv(data0["transform"])).astype(
                np.float32)
        elif self.conf.extra_data is not None:
            raise ValueError(f"unknown extra_data {self.conf.extra_data!r}")
        data["name"] = names_to_pair(name0, name1)
        data["idx"] = idx
        return data


class ImagePairs(BaseDataset):
    default_conf = {
        "pairs": "???",
        "root": "???",
        "preprocessing": {},
        "extra_data": None,  # relative_pose | homography | None
    }

    def _init(self, conf):
        pair_f = Path(conf.pairs) if Path(conf.pairs).exists() else settings.DATA_PATH / conf.pairs
        if not pair_f.exists():
            raise FileNotFoundError(f"pairs file {pair_f} not found")
        with open(pair_f) as f:
            self.items = [line.rstrip() for line in f if line.strip()]
        self.preprocessor = ImagePreprocessor(conf.preprocessing)

    def get_dataset(self, split):
        return _PairItems(self)
