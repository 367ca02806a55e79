"""SuperPoint keypoint detector and descriptor, vanilla variant
(counterpart of `gluefactory_tpu/models/extractors/superpoint.py` with its
non-fused decode).

Parameters carry the official MagicLeap names (`conv1a` ... `convDb`, each
an `nn.Conv2d`), so `superpoint_v1.pth` loads as it is. The network runs
channels-first; the data contract stays that of the JAX package: images
(B, H, W, C) in [0, 1], keypoints in the COLMAP convention (+0.5), exactly
`max_num_keypoints` keypoints per image with a `keypoint_mask`.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.grid_sample import sample_descriptors
from ...ops.nms import remove_borders, simple_nms, top_k_keypoints
from ..base_model import BaseModel


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 1), luminance weights."""
    if image.shape[-1] == 1:
        return image
    w = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=image.device)
    return (image * w).sum(dim=-1, keepdim=True)


def detector_scores(logits: torch.Tensor) -> torch.Tensor:
    """Detector logits (B, 65, Hc, Wc) -> score map (B, 8*Hc, 8*Wc): softmax
    over the 65 channels, drop the dustbin, 8x8 pixel shuffle in which
    channel dy*8+dx of cell (hc, wc) is pixel (8*hc+dy, 8*wc+dx)."""
    scores = logits.softmax(dim=1)[:, :64]
    B, _, Hc, Wc = scores.shape
    scores = scores.reshape(B, 8, 8, Hc, Wc).permute(0, 3, 1, 4, 2)
    return scores.reshape(B, Hc * 8, Wc * 8)


class SuperPoint(BaseModel):
    default_conf = {
        "variant": "vanilla",
        "descriptor_dim": 256,
        "nms_radius": 4,
        "max_num_keypoints": 1024,
        "max_num_keypoints_val": None,
        "force_num_keypoints": False,
        "detection_threshold": 0.005,
        "remove_borders": 4,
        "dense_outputs": False,
        "channels": [64, 64, 128, 128],
        "head_channels": 256,
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        if conf.variant != "vanilla":
            raise NotImplementedError(f"SuperPoint variant {conf.variant!r} is not ported yet")
        chans = [1, *conf.channels]
        for i in range(len(conf.channels)):
            setattr(self, f"conv{i+1}a", nn.Conv2d(chans[i], chans[i + 1], 3, padding=1))
            setattr(self, f"conv{i+1}b", nn.Conv2d(chans[i + 1], chans[i + 1], 3, padding=1))
        c = conf.channels[-1]
        self.convPa = nn.Conv2d(c, conf.head_channels, 3, padding=1)
        self.convPb = nn.Conv2d(conf.head_channels, 65, 1)
        self.convDa = nn.Conv2d(c, conf.head_channels, 3, padding=1)
        self.convDb = nn.Conv2d(conf.head_channels, conf.descriptor_dim, 1)

    def _forward(self, data: dict, generator: torch.Generator | None = None) -> dict:
        """`generator` draws the random keypoints that fill invalid slots
        under `force_num_keypoints` (a fresh one seeded with 0 if None)."""
        image = rgb_to_grayscale(data["image"])
        x = image.permute(0, 3, 1, 2)
        relu = torch.relu
        n_blocks = len(self.conf.channels)
        for i in range(n_blocks):
            x = relu(getattr(self, f"conv{i+1}a")(x))
            x = relu(getattr(self, f"conv{i+1}b")(x))
            if i < n_blocks - 1:
                x = nn.functional.max_pool2d(x, 2, 2)
        logits = self.convPb(relu(self.convPa(x)))  # (B, 65, Hc, Wc)
        dense_desc = self.convDb(relu(self.convDa(x)))  # (B, D, Hc, Wc)
        return self._decode(data, image, logits, dense_desc, generator)

    def _decode(self, data, image, logits, dense_desc, generator):
        c = self.conf
        scores = detector_scores(logits)
        B = scores.shape[0]
        dense_desc = dense_desc / (torch.linalg.vector_norm(dense_desc, dim=1, keepdim=True) + 1e-8)

        # inference: the eval-time override applies
        k = int(c.max_num_keypoints if c.max_num_keypoints_val is None else c.max_num_keypoints_val)
        nmsed = remove_borders(simple_nms(scores, c.nms_radius), c.remove_borders)
        true_size = data.get("image_size")
        if true_size is not None:
            # no detections beyond the true image area of a padded buffer
            Hs, Ws = scores.shape[1:]
            xs = torch.arange(Ws, dtype=torch.float32, device=scores.device)[None, None, :]
            ys = torch.arange(Hs, dtype=torch.float32, device=scores.device)[None, :, None]
            b_ = float(c.remove_borders)
            in_area = (xs < true_size[:, 0, None, None] - b_) & (ys < true_size[:, 1, None, None] - b_)
            nmsed = torch.where(in_area, nmsed, torch.zeros_like(nmsed))
        kpts, kpt_scores, valid = top_k_keypoints(
            nmsed, k, c.detection_threshold, nms_radius=c.nms_radius
        )

        if c.force_num_keypoints:
            size = true_size
            if size is None:
                h, w = image.shape[1:3]
                size = torch.tensor([[w, h]], dtype=torch.float32, device=kpts.device).expand(B, 2)
            if generator is None:
                generator = torch.Generator(device=kpts.device).manual_seed(0)
            u = torch.rand((B, k, 2), generator=generator, device=kpts.device, dtype=kpts.dtype)
            rand_kpts = u * size[:, None, :]
            kpts = torch.where(valid[..., None], kpts, rand_kpts)
            kpt_scores = torch.where(valid, kpt_scores, torch.zeros_like(kpt_scores))
            valid = torch.ones_like(valid)

        desc = sample_descriptors(kpts, dense_desc.permute(0, 2, 3, 1), stride=8)
        pred = {
            "keypoints": kpts,
            "keypoint_scores": kpt_scores,
            "keypoint_mask": valid,
            "descriptors": desc,
        }
        if c.dense_outputs:
            pred["dense_descriptors"] = dense_desc.permute(0, 2, 3, 1)
            pred["dense_score_map"] = scores
        return pred
