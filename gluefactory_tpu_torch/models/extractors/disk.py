"""DISK keypoint detector and descriptor (counterpart of
`gluefactory_tpu/models/extractors/disk.py`).

A thin U-Net: each block is InstanceNorm (no affine parameters) -> PReLU
(one weight a channel) -> 5x5 conv, the first block the conv alone; down
channels [16, 32, 64, 64, 64] with 2x2 average pooling between levels,
nearest upsampling and concatenation with the skip on the way up, out
channels [64, 64, 64, desc_dim + 1]. The output splits into `desc_dim`
dense descriptors and a one-channel heatmap; keypoints are its window-NMS
maxima (radius (nms_window_size - 1) // 2) above the threshold, top-k
with a mask. Parameters carry kornia's names (`unet.path_down.{i}.conv`
and `unet.path_up.{i}.conv`, Sequentials whose conv sits at index 2, at 0
in the first block), so its `depth` checkpoint loads once it is on disk.

The upsampling uses half-pixel centres (`nearest-exact`), as
`jax.image.resize(..., "nearest")` does; it differs from `nearest` where a
level is not exactly twice the next (odd sizes without
`pad_if_not_divisible`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.grid_sample import sample_descriptors
from ...ops.nms import simple_nms, top_k_keypoints
from ...utils.distributed import batch_rand
from ..base_model import BaseModel

DOWN = (16, 32, 64, 64, 64)
UP = (64, 64, 64)


class ThinBlock(nn.Module):
    """`conv`: Sequential(InstanceNorm2d, PReLU, Conv2d 5x5), or the conv
    alone in the first block."""

    def __init__(self, c_in: int, c_out: int, first: bool = False):
        super().__init__()
        layers = [] if first else [nn.InstanceNorm2d(c_in, eps=1e-5), nn.PReLU(c_in, init=0.25)]
        self.conv = nn.Sequential(*layers, nn.Conv2d(c_in, c_out, 5, padding=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        chans = [in_channels, *DOWN]
        self.path_down = nn.ModuleList(ThinBlock(chans[i], chans[i + 1], first=i == 0)
                                       for i in range(len(DOWN)))
        ups, c, blocks = (*UP, out_channels), DOWN[-1], []
        for i, c_out in enumerate(ups):
            skip = DOWN[-(i + 2)]
            blocks.append(ThinBlock(c + skip, c_out))
            c = c_out
        self.path_up = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i, block in enumerate(self.path_down):
            if i > 0:
                skips.append(x)
                x = F.avg_pool2d(x, 2)
            x = block(x)
        for i, block in enumerate(self.path_up):
            skip = skips[-(i + 1)]
            x = F.interpolate(x, size=skip.shape[2:], mode="nearest-exact")
            x = block(torch.cat([x, skip], dim=1))
        return x


class DISK(BaseModel):
    default_conf = {
        "weights": None,  # the name of kornia's checkpoint ("depth"); load it by weights_file
        "dense_outputs": False,
        "max_num_keypoints": 2048,
        "desc_dim": 128,
        "nms_window_size": 5,
        "detection_threshold": 0.0,
        "force_num_keypoints": False,
        "pad_if_not_divisible": True,
        "chunk": 4,  # kept for the conf's sake: the batch runs whole
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        self.unet = UNet(3, conf.desc_dim + 1)

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        """`generator` draws the random keypoints that fill invalid slots
        under `force_num_keypoints` (a fresh one seeded with 0 if None)."""
        c = self.conf
        image = data["image"]
        B, H, W, C = image.shape
        x = image.permute(0, 3, 1, 2)
        if C == 1:
            x = x.expand(B, 3, H, W)
        if c.pad_if_not_divisible and (H % 16 or W % 16):
            x = F.pad(x, (0, -W % 16, 0, -H % 16))  # zeros, bottom and right
        out = self.unet(x)
        desc_map = out[:, :c.desc_dim, :H, :W].permute(0, 2, 3, 1)
        heatmap = out[:, -1, :H, :W]

        nmsed = simple_nms(heatmap, (int(c.nms_window_size) - 1) // 2)
        true_size = data.get("image_size")
        if true_size is not None:
            ts = true_size.to(device=image.device, dtype=torch.float32)
            xs = torch.arange(W, dtype=torch.float32, device=image.device)[None, None, :]
            ys = torch.arange(H, dtype=torch.float32, device=image.device)[None, :, None]
            in_area = (xs < ts[:, 0, None, None]) & (ys < ts[:, 1, None, None])
            nmsed = torch.where(in_area, nmsed, torch.zeros_like(nmsed))  # -inf, then 0
        k = int(c.max_num_keypoints)
        kpts, scores, valid = top_k_keypoints(nmsed, k, c.detection_threshold)
        if c.force_num_keypoints:
            if generator is None:
                generator = torch.Generator(device=image.device).manual_seed(0)
            size = true_size
            if size is None:
                size = torch.tensor([[W, H]], dtype=torch.float32, device=image.device).expand(B, 2)
            u = batch_rand((B, k, 2), generator, image.device, kpts.dtype)
            kpts = torch.where(valid[..., None], kpts, u * size[:, None, :].to(kpts.dtype))
            valid = torch.ones_like(valid)
        desc = sample_descriptors(kpts, desc_map, stride=1)
        pred = {
            "keypoints": kpts,
            "keypoint_scores": scores,
            "keypoint_mask": valid,
            "descriptors": desc,
        }
        if c.dense_outputs:
            pred["dense_descriptors"] = desc_map
        return pred

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError
