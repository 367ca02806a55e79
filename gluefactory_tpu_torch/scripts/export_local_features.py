"""Export an extractor's features for every image of a folder
(counterpart of `gluefactory_tpu/scripts/export_local_features.py`) into
one HDF5 file, one group per image under its path relative to the folder.

    python -m gluefactory_tpu_torch.scripts.export_local_features \\
        --image_dir /path/to/images --method superpoint \\
        --output exports/features.h5 [--resize 1024] [--num_keypoints 2048] [--as_half] \\
        [--device cpu]

The extractor runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .. import logger
from ..data import get_dataset
from ..eval.io import make_apply_fn
from ..utils.export_predictions import export_predictions
from .export_megadepth import build_extractor

METHOD_CONFS = {
    "superpoint": {"name": "superpoint", "nms_radius": 3, "detection_threshold": 0.0},
    "superpoint_open": {"name": "superpoint_open", "detection_threshold": 0.0},
    "sift": {"name": "sift"},
    "disk": {"name": "disk", "detection_threshold": 0.0},
    "aliked": {"name": "aliked", "detection_threshold": 0.0},
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--method", type=str, default="superpoint", choices=sorted(METHOD_CONFS))
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--resize", type=int, default=None)
    parser.add_argument("--num_keypoints", type=int, default=2048)
    parser.add_argument("--as_half", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    conf = {**METHOD_CONFS[args.method], "max_num_keypoints": args.num_keypoints}
    model = build_extractor(conf, device=args.device)
    dataset = get_dataset("image_folder")({
        "images": args.image_dir,
        "preprocessing": {"resize": args.resize} if args.resize else {},
    })
    loader = dataset.get_data_loader("test")
    logger.info("Exporting %d images with %s", len(loader), args.method)
    return export_predictions(loader, make_apply_fn(model, args.device), Path(args.output),
                              as_half=args.as_half)


if __name__ == "__main__":
    main()
