"""Export an extractor's features for every image of every MegaDepth scene
(counterpart of `gluefactory_tpu/scripts/export_megadepth.py`), one HDF5
file a scene, `DATA_PATH/exports/megadepth-undist-depth-<tag>/{scene}.h5`:
the cache that `data.load_features` reads for stage-2 training without the
extractor (`models/cache_loader.py`). Keypoints are stored at the original
resolution, floats as float16; `--with_depth` adds each keypoint's depth
(`depth_keypoints`) and its validity (`valid_depth_keypoints`, bool).

    python -m gluefactory_tpu_torch.scripts.export_megadepth --method sp \\
        [--scenes scene_list.txt] [--num_workers 8] [--resize 1024] [--with_depth] \\
        [--weights_file superpoint.pth] [--device cpu]

The extractor runs on the card unless `--device cpu`; `--weights_file` is
a `torch.save` state dict of the extractor (else its weights are random).
A scene whose file exists is skipped.

Divergences from the JAX package, whose caches `data.load_features`
cannot read: each scene's images are taken from the split's full item list
(the JAX script narrows the list in place, so every scene after the first
gets no images); and each image's group is its file name, the name the
datasets' cache loader asks for (the JAX script writes the single-view
item's name, `<scene>/<image>`, as nested groups).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import logger, settings
from ..data import get_dataset
from ..data.base_dataset import collate
from ..eval.io import load_model, make_apply_fn
from ..geometry.depth import sample_depth
from ..utils.export_predictions import export_predictions

# extractor configurations, as the JAX package's
METHODS = {
    "sp": {
        "tag": "r1024_SP-k2048-nms3",
        "model": {"name": "superpoint", "max_num_keypoints": 2048, "nms_radius": 3,
                  "detection_threshold": 0.0},
    },
    "sp_open": {
        "tag": "r1024_SPopen-k2048-nms3",
        "model": {"name": "superpoint_open", "max_num_keypoints": 2048, "detection_threshold": 0.0},
    },
    "sift": {
        "tag": "r1024_SIFT-k4096-nms4",
        "model": {"name": "sift", "max_num_keypoints": 4096, "nms_radius": 4},
    },
    "disk": {
        "tag": "r1024_DISK-k2048-nms5",
        "model": {"name": "disk", "max_num_keypoints": 2048, "nms_window_size": 11},
    },
    "aliked": {
        "tag": "r1024_ALIKED-k2048-n16",
        "model": {"name": "aliked", "max_num_keypoints": 2048},
    },
}
# the extractors of METHODS that this package has
PORTED = {"superpoint", "superpoint_open", "sift", "disk", "aliked"}


def build_extractor(model_conf: dict, weights_file=None, device="cuda"):
    """The extractor of a METHODS entry, in eval mode on `device`, with
    `weights_file` loaded where given."""
    if model_conf["name"] not in PORTED:
        raise NotImplementedError(f"extractor {model_conf['name']!r} is not ported")
    return load_model({**model_conf, "weights_file": weights_file}, None, device)


def depth_callback(pred: dict, data: dict) -> dict:
    """Each keypoint's depth, sampled (bilinear) from the item's depth map
    in the processed image, and its validity."""
    depth = data.get("depth")
    if depth is None or "keypoints" not in pred:
        return {}
    d, valid = sample_depth(torch.from_numpy(np.asarray(pred["keypoints"])[None]),
                            torch.from_numpy(np.asarray(depth)[None]))
    return {"depth_keypoints": d[0].numpy(), "valid_depth_keypoints": valid[0].numpy()}


class _ByImageName(torch.utils.data.Dataset):
    """A scene's single views, each named by its image file."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        data = self.items[idx]
        data["name"] = data["name"].split("/", 1)[-1]
        return data


def export_root(method: str):
    return settings.DATA_PATH / "exports" / ("megadepth-undist-depth-" + METHODS[method]["tag"])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--method", type=str, default="sp", choices=sorted(METHODS))
    parser.add_argument("--scenes", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--resize", type=int, default=1024)
    parser.add_argument("--with_depth", action="store_true")
    parser.add_argument("--weights_file", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    method = METHODS[args.method]
    root = export_root(args.method)
    root.mkdir(parents=True, exist_ok=True)
    model = build_extractor(method["model"], args.weights_file, args.device)
    apply_fn = make_apply_fn(model, args.device)

    dataset = get_dataset("megadepth")({
        "train_split": args.scenes or "train_scenes_clean.txt",
        "views": 1,
        "train_num_per_scene": None,
        "read_depth": args.with_depth,
        "preprocessing": {"resize": args.resize, "side": "long"},
        "num_workers": args.num_workers,
    })
    tds = dataset.get_dataset("train")
    all_items = list(tds.items)
    written = []
    for scene in sorted({item[0] for item in all_items}):
        out_file = root / f"{scene}.h5"
        if out_file.exists():
            logger.info("Skipping %s (exists)", scene)
            continue
        tds.items = [it for it in all_items if it[0] == scene]
        loader = torch.utils.data.DataLoader(_ByImageName(tds), batch_size=1,
                                             num_workers=args.num_workers, collate_fn=collate)
        logger.info("Exporting %s (%d images)", scene, len(tds.items))
        export_predictions(loader, apply_fn, out_file, as_half=True,
                           callback_fn=depth_callback if args.with_depth else None)
        written.append(out_file)
    return written


if __name__ == "__main__":
    main()
