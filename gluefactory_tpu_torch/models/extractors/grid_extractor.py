"""Regular-grid "keypoints" for dense and semi-dense matching (counterpart
of `gluefactory_tpu/models/extractors/grid_extractor.py`): the centre of
each `cell_size` cell that lies whole in the image, row by row, every one
valid with score 1. RoMa's sparse mode snaps them through its warps."""

from __future__ import annotations

import torch

from ..base_model import BaseModel


class GridExtractor(BaseModel):
    default_conf = {"cell_size": 14, "extract_descriptors": False}
    required_data_keys = ["image"]

    def _init(self, conf):
        pass

    def _forward(self, data: dict, generator: torch.Generator | None = None, train: bool = False) -> dict:
        image = data["image"]  # (B, H, W, C)
        B, H, W = image.shape[:3]
        cs = self.conf.cell_size
        x = (torch.arange(W // cs, dtype=torch.float32, device=image.device) + 0.5) * cs
        y = (torch.arange(H // cs, dtype=torch.float32, device=image.device) + 0.5) * cs
        xx, yy = torch.meshgrid(x, y, indexing="xy")
        kpts = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)[None].expand(B, -1, -1).contiguous()
        N = kpts.shape[1]
        return {
            "keypoints": kpts,
            "keypoint_scores": torch.ones((B, N), dtype=torch.float32, device=image.device),
            "keypoint_mask": torch.ones((B, N), dtype=torch.bool, device=image.device),
        }

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError
