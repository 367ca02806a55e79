"""HPatches homography-benchmark dataset (counterpart of
`gluefactory_tpu/data/hpatches.py`).

Layout: `hpatches-sequences-release/<i_X|v_X>/{1..6}.ppm, H_1_{2..6}`:
116 sequences x 5 pairs, 8 over-large scenes left out. The ground-truth
homography is rescaled into the processed images' coordinates by the two
views' scales, H' = S1 H S0^-1. Nothing is downloaded: `data_dir` names a
copy under `DATA_PATH`.
"""

from __future__ import annotations

import numpy as np

from .. import settings
from .base_dataset import BaseDataset
from .preprocess import ImagePreprocessor, read_image

# scenes the reference leaves out (images larger than 1200 px)
IGNORED_SCENES = (
    "i_contruction",
    "i_crownnight",
    "i_dc",
    "i_pencils",
    "i_whitebuilding",
    "v_artisans",
    "v_astronautis",
    "v_talent",
)


def read_homography(path) -> np.ndarray:
    """A 3 x 3 homography from a text file of whitespace-separated numbers."""
    with open(path) as f:
        values = [float(v) for v in f.read().split()]
    return np.array(values).reshape(3, 3).astype(np.float32)


class _HPatchesItems:
    def __init__(self, parent, items):
        self.parent = parent
        self.items = items

    def __len__(self):
        return len(self.items)

    def _read_view(self, seq: str, idx: int) -> dict:
        img = read_image(self.parent.root / seq / f"{idx}.ppm", grayscale=self.parent.conf.grayscale)
        return self.parent.preprocessor(img)

    def __getitem__(self, i: int) -> dict:
        seq, q_idx = self.items[i]
        view0 = self._read_view(seq, 1)
        view1 = self._read_view(seq, q_idx)
        H = read_homography(self.parent.root / seq / f"H_1_{q_idx}")
        s0, s1 = view0["scales"], view1["scales"]
        S0_inv = np.diag([1.0 / s0[0], 1.0 / s0[1], 1.0])
        S1 = np.diag([s1[0], s1[1], 1.0])
        return {
            "view0": view0,
            "view1": view1,
            "H_0to1": (S1 @ H @ S0_inv).astype(np.float32),
            "idx": i,
            "name": f"{seq}/{q_idx}.ppm",
            "scene": seq,
        }


class HPatchesDataset(BaseDataset):
    default_conf = {
        "data_dir": "hpatches-sequences-release",
        "preprocessing": {"resize": 480, "side": "short"},
        "subset": None,  # "i" | "v" | None
        "ignore_large_images": True,
        "grayscale": False,
    }

    def _init(self, conf):
        self.root = settings.DATA_PATH / conf.data_dir
        if not self.root.exists():
            raise FileNotFoundError(
                f"HPatches not found at {self.root}: put hpatches-sequences-release there "
                "(nothing is downloaded)")
        self.preprocessor = ImagePreprocessor(conf.preprocessing)
        items = []
        for seq in sorted(x.name for x in self.root.iterdir() if x.is_dir()):
            if conf.ignore_large_images and seq in IGNORED_SCENES:
                continue
            if conf.subset is not None and conf.subset != seq[0]:
                continue
            items += [(seq, q_idx) for q_idx in range(2, 7)]
        self.items = items

    def get_dataset(self, split: str):
        if split not in ("val", "test"):
            raise ValueError(f"HPatches has the splits val and test, not {split!r}")
        return _HPatchesItems(self, self.items)


def main(argv=None):
    """Write a grid of the first test pairs' two views (HPatches under
    DATA_PATH)."""
    import argparse

    from ..visualization.viz2d import save_image_grid

    parser = argparse.ArgumentParser()
    parser.add_argument("--num_items", type=int, default=4)
    parser.add_argument("--out", type=str, default="hpatches_samples.png")
    args = parser.parse_args(argv)
    tds = HPatchesDataset({}).get_dataset("test")
    rows = [[tds[i]["view0"]["image"], tds[i]["view1"]["image"]]
            for i in range(min(args.num_items, len(tds)))]
    save_image_grid(args.out, rows, save_dpi=120)


if __name__ == "__main__":
    main()
