"""A folder of images for feature export (counterpart of
`gluefactory_tpu/data/image_folder.py`): every file matching `glob` below
`images` (a folder, relative to `DATA_PATH` unless absolute), or an
explicit list of image paths, read by `preprocess.read_image` and
preprocessed. An item's `name` is its path relative to the folder (to the
first image's folder for a list), the key `scripts/export_local_features.py`
writes it under."""

from __future__ import annotations

from pathlib import Path

import torch

from .. import settings
from .base_dataset import BaseDataset
from .preprocess import ImagePreprocessor, read_image


class _FolderItems(torch.utils.data.Dataset):
    def __init__(self, parent: "ImageFolder"):
        self.parent = parent

    def __len__(self):
        return len(self.parent.images)

    def __getitem__(self, idx):
        path = self.parent.images[idx]
        data = self.parent.preprocessor(read_image(path, grayscale=self.parent.conf.grayscale))
        data["name"] = str(path.relative_to(self.parent.root))
        data["idx"] = idx
        return data


class ImageFolder(BaseDataset):
    default_conf = {
        "glob": ["*.jpg", "*.png", "*.jpeg", "*.JPG", "*.PNG", "*.ppm"],
        "images": "???",  # a folder, or a list of image paths
        "root_folder": "/",
        "preprocessing": {},
        "grayscale": False,
    }

    def _init(self, conf):
        self.root = Path(conf.root_folder)
        if isinstance(conf.images, str):
            folder = Path(conf.images)
            if not folder.is_absolute():
                folder = settings.DATA_PATH / folder
            if not folder.exists():
                raise FileNotFoundError(f"image folder {folder} not found")
            self.images = [p for g in conf.glob for p in sorted(folder.rglob(g))]
            self.root = folder
        else:
            self.images = [Path(p) for p in conf.images]
            self.root = self.images[0].parent if self.images else Path("/")
        self.preprocessor = ImagePreprocessor(conf.preprocessing)

    def get_dataset(self, split):
        return _FolderItems(self)
