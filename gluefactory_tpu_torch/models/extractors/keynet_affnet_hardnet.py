"""KeyNet detector, dominant-gradient orientation and HardNet descriptor
(counterpart of `gluefactory_tpu/models/extractors/keynet_affnet_hardnet.py`,
the role of kornia's `KeyNetHardNet` that glue-factory wraps; despite the
name, no AffNet).

- **KeyNet**: ten handcrafted derivative maps (gx, gy, gx^2, gy^2, gx gy,
  gxx, gyy, gxy, gxx gyy, gxy^2, from Sobel / 8 with zero padding) and a
  shared learned block (three 5x5 convs of 8 filters, BatchNorm, ReLU) on
  a 3-level pyramid of factor 1.2 (reflection-padded 5-tap binomial blur,
  then an antialiased bilinear downsample to the floored size, as
  `jax.image.resize` does); the levels' maps bilinearly upsampled, stacked
  and reduced by a 5x5 conv with ReLU to the response map. Keypoints are its
  NMS maxima, top-k with a mask (`ops/nms.py`); `force_num_keypoints` fills
  the invalid slots with random points from the generator.
- **Orientation**: a 32 x 32 upright patch a keypoint (radius
  `patch_scale`), central-difference gradients, a Gaussian-weighted
  36-bin histogram of their angles (floor of the angle into its bin,
  scatter-added), smoothed twice by (1 4 6 4 1) / 16 around the circle,
  its argmax refined by a parabola. Two bins within rounding of each other
  may tie differently from the JAX package's sums (the tests count them).
- **HardNet**: 32 x 32 patches at the keypoint's orientation, normalised by
  their mean and population std (+1e-6); six 3x3 convs (32, 32, 64, 64,
  128, 128; strides 1, 1, 2, 1, 2, 1) with flax's SAME padding, so a stride-2
  conv pads (0, 1) where kornia pads (1, 1); BatchNorms without affine
  parameters, ReLU; an 8 x 8 VALID conv and a BatchNorm; L2-normalised.

Parameters carry the names of kornia's `KeyNetHardNet` checkpoint:
`detector.model.feature_extractor.lb_block.conv{i}.{0,1}`,
`detector.model.last_conv.0` and `descriptor.descriptor.features.{i}` (the
convs at 0, 3, 6, 9, 12, 15 and 19, their BatchNorms right after), so such a
state dict loads with strict=True once its orientation network's tensors
(`detector.ori.*`, kornia's OriNet, which the JAX module replaces by the
dominant gradient) are dropped. Evaluation only: `loss` raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.batch_norm import batch_norm
from ...ops.nms import simple_nms, top_k_keypoints
from ...utils.distributed import batch_rand
from ..base_model import BaseModel

GRAY = (0.299, 0.587, 0.114)
BN_MOMENTUM = 0.9  # flax's: the weight of the old running value
PATCH = 32
# (angle + pi) / (2 pi) * 36 as XLA compiles it: the division by a constant
# becomes a product with its float32 reciprocal, folded with the 36; an
# angle of exactly +-pi/2 (a patch clipped at the image's edge has many)
# then falls below its bin's edge, where the quotient lands on it
BIN_SCALE = np.float32(np.float32(1.0) / np.float32(2 * math.pi)) * np.float32(36.0)
HARDNET = ((32, 1), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1))


def spatial_gradient(x: torch.Tensor):
    """Sobel / 8 first derivatives of (B, 1, H, W), zero padding."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      dtype=x.dtype, device=x.device) / 8.0
    k = torch.stack([kx, kx.T])[:, None]  # (2, 1, 3, 3)
    g = F.conv2d(x, k, padding=1)
    return g[:, :1], g[:, 1:]


def handcrafted_features(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) -> KeyNet's ten handcrafted maps (B, 10, H, W)."""
    gx, gy = spatial_gradient(x)
    gxx, gxy = spatial_gradient(gx)
    _, gyy = spatial_gradient(gy)
    return torch.cat([gx, gy, gx * gx, gy * gy, gx * gy, gxx, gyy, gxy, gxx * gyy, gxy * gxy], dim=1)


def _pyrdown(x: torch.Tensor, factor: float = 1.2) -> torch.Tensor:
    """Blur (B, C, H, W) with the 5-tap binomial after reflection padding,
    then resize bilinearly (antialiased) to the floored size H / factor."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=x.dtype, device=x.device) / 16.0
    C = x.shape[1]
    x = F.conv2d(F.pad(x, (0, 0, 2, 2), mode="reflect"), k.view(1, 1, 5, 1).expand(C, 1, 5, 1),
                 groups=C)
    x = F.conv2d(F.pad(x, (2, 2, 0, 0), mode="reflect"), k.view(1, 1, 1, 5).expand(C, 1, 1, 5),
                 groups=C)
    H, W = x.shape[2:]
    size = (max(int(H / factor), 1), max(int(W / factor), 1))
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


def _conv_bn(c_in: int, c_out: int) -> nn.Sequential:
    """kornia's learnable-block unit: 5x5 conv without bias, BatchNorm, ReLU."""
    return nn.Sequential(nn.Conv2d(c_in, c_out, 5, padding=2, bias=False), nn.BatchNorm2d(c_out),
                         nn.ReLU())


class LearnableBlock(nn.Module):
    def __init__(self, c_in: int = 10, filters: int = 8):
        super().__init__()
        self.conv0 = _conv_bn(c_in, filters)
        self.conv1 = _conv_bn(filters, filters)
        self.conv2 = _conv_bn(filters, filters)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for unit in (self.conv0, self.conv1, self.conv2):
            x = F.relu(batch_norm(unit[1], unit[0](x), train, BN_MOMENTUM))
        return x


class FeatureExtractor(nn.Module):
    def __init__(self, filters: int = 8):
        super().__init__()
        self.lb_block = LearnableBlock(10, filters)


class KeyNet(nn.Module):
    """The response map (B, H, W) of (B, 1, H, W) grey images."""

    def __init__(self, levels: int = 3, filters: int = 8, factor: float = 1.2):
        super().__init__()
        self.levels, self.factor = levels, factor
        self.feature_extractor = FeatureExtractor(filters)
        self.last_conv = nn.Sequential(nn.Conv2d(levels * filters, 1, 5, padding=2), nn.ReLU())

    def forward(self, img: torch.Tensor, train: bool = False) -> torch.Tensor:
        H, W = img.shape[2:]
        feats, x = [], img
        for lv in range(self.levels):
            f = self.feature_extractor.lb_block(handcrafted_features(x), train)
            if lv > 0:
                f = F.interpolate(f, size=(H, W), mode="bilinear", align_corners=False)
            feats.append(f)
            if lv + 1 < self.levels:
                x = _pyrdown(x, self.factor)
        return self.last_conv(torch.cat(feats, dim=1))[:, 0]


class HardNet(nn.Module):
    """(N, 1, 32, 32) normalised patches -> (N, 128) unit descriptors;
    `features` indexed as kornia's Sequential (ReLUs and its dropout
    included, so the convs and BatchNorms keep their indices)."""

    def __init__(self):
        super().__init__()
        layers, c = [], 1
        for c_out, _ in HARDNET:
            layers += [nn.Conv2d(c, c_out, 3, bias=False), nn.BatchNorm2d(c_out, affine=False),
                       nn.ReLU()]
            c = c_out
        layers += [nn.Dropout(0.3), nn.Conv2d(128, 128, 8, bias=False),
                   nn.BatchNorm2d(128, affine=False)]
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i, (_, stride) in enumerate(HARDNET):
            conv, bn = self.features[3 * i], self.features[3 * i + 1]
            # flax SAME: pad (k - s) split low-first: (1, 1) at stride 1,
            # (0, 1) at stride 2 on an even size
            pad = (1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1)
            x = F.conv2d(F.pad(x, pad), conv.weight, stride=stride)
            x = F.relu(batch_norm(bn, x, train, BN_MOMENTUM))
        x = batch_norm(self.features[20], self.features[19](x), train, BN_MOMENTUM)
        x = x.flatten(1)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)


def extract_patches(img: torch.Tensor, kpts: torch.Tensor, scales: torch.Tensor,
                    oris: torch.Tensor, size: int = PATCH) -> torch.Tensor:
    """Bilinear (size x size) patches of img (B, H, W) around kpts (B, K, 2)
    (pixel centres at +0.5), of radius `scales` (B, K) px, rotated by `oris`
    (B, K): (B, K, size, size). The taps' origins are clipped to
    [0, W - 2] x [0, H - 2] and their fractions to [0, 1]."""
    B, H, W = img.shape
    K = kpts.shape[1]
    g = (torch.arange(size, dtype=torch.float32, device=img.device) + 0.5) / size * 2.0 - 1.0
    gxx, gyy = g[None, None, None, :], g[None, None, :, None]
    cs, sn = torch.cos(oris)[..., None, None], torch.sin(oris)[..., None, None]
    px = gxx * cs - gyy * sn
    py = gxx * sn + gyy * cs
    sx = kpts[..., 0, None, None] - 0.5 + px * scales[..., None, None]
    sy = kpts[..., 1, None, None] - 0.5 + py * scales[..., None, None]
    x0 = torch.floor(sx).clamp(0, W - 2)
    y0 = torch.floor(sy).clamp(0, H - 2)
    fx = (sx - x0).clamp(0.0, 1.0)
    fy = (sy - y0).clamp(0.0, 1.0)
    flat = img.reshape(B, H * W)
    x0, y0 = x0.long(), y0.long()

    def read(y, x):
        return flat.gather(1, (y * W + x).reshape(B, -1)).reshape(B, K, size, size)

    return (read(y0, x0) * (1 - fx) * (1 - fy) + read(y0, x0 + 1) * fx * (1 - fy)
            + read(y0 + 1, x0) * (1 - fx) * fy + read(y0 + 1, x0 + 1) * fx * fy)


def orientation_histogram(patches: torch.Tensor) -> torch.Tensor:
    """(..., S, S) patches -> their smoothed 36-bin gradient-orientation
    histograms (..., 36)."""
    lead, S = patches.shape[:-2], patches.shape[-1]
    p = patches.reshape(-1, S, S)
    gx = 0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])
    gy = 0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    d = S - 2
    ii = (torch.arange(d, dtype=torch.float32, device=p.device) - (d - 1) / 2.0) / (d / 2)
    w = torch.exp(-(ii[None, :, None] ** 2 + ii[None, None, :] ** 2) / 0.5)
    wm = (mag * w).reshape(p.shape[0], -1)
    bins = torch.floor((ang + math.pi) * BIN_SCALE).clamp(0, 35).long().reshape(p.shape[0], -1)
    hist = torch.zeros(p.shape[0], 36, dtype=torch.float32, device=p.device).scatter_add_(1, bins, wm)
    for _ in range(2):
        hist = (6 * hist + 4 * (torch.roll(hist, 1, -1) + torch.roll(hist, -1, -1))
                + torch.roll(hist, 2, -1) + torch.roll(hist, -2, -1)) / 16.0
    return hist.reshape(*lead, 36)


def dominant_orientation(patches: torch.Tensor) -> torch.Tensor:
    """(..., S, S) patches -> the angle (...) of their histogram's peak,
    refined by a parabola through it and its neighbours, in [-pi, pi]."""
    hist = orientation_histogram(patches)
    b = hist.argmax(-1, keepdim=True)
    hb = hist.gather(-1, b)[..., 0]
    hl = hist.gather(-1, (b - 1) % 36)[..., 0]
    hr = hist.gather(-1, (b + 1) % 36)[..., 0]
    den = hl - 2 * hb + hr
    frac = torch.where(den.abs() > 1e-8, 0.5 * (hl - hr) / den, torch.zeros_like(den))
    return (b[..., 0].float() + 0.5 + frac) * (2 * math.pi / 36) - math.pi


class Detector(nn.Module):
    def __init__(self):
        super().__init__()
        self.model = KeyNet()


class Descriptor(nn.Module):
    def __init__(self):
        super().__init__()
        self.descriptor = HardNet()


class KeyNetAffNetHardNet(BaseModel):
    default_conf = {
        "max_num_keypoints": 2048,
        "nms_radius": 4,
        "detection_threshold": 0.0,
        "patch_scale": 12.0,  # the patch radius in px at the response's scale
        "upright": False,  # no orientation: every patch upright
        "force_num_keypoints": False,
        "trainable": False,
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        self.detector = Detector()
        self.descriptor = Descriptor()

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        """`generator` draws the random keypoints that fill invalid slots
        under `force_num_keypoints` (a fresh one seeded with 0 if None)."""
        c = self.conf
        image = data["image"]
        if image.shape[-1] == 3:
            image = (image * torch.tensor(GRAY, dtype=image.dtype, device=image.device)).sum(-1, keepdim=True)
        B, H, W, _ = image.shape
        k = int(c.max_num_keypoints)
        gray = image[..., 0].float()
        resp = self.detector.model(gray[:, None], train)
        nmsed = simple_nms(resp, int(c.nms_radius))
        kpts, scores, valid = top_k_keypoints(nmsed, k, float(c.detection_threshold),
                                              nms_radius=int(c.nms_radius))
        if c.force_num_keypoints:
            if generator is None:
                generator = torch.Generator(device=image.device).manual_seed(0)
            size = data.get("image_size")
            if size is None:
                size = torch.tensor([[W, H]], dtype=torch.float32, device=image.device).expand(B, 2)
            u = batch_rand((B, k, 2), generator, image.device, kpts.dtype)
            kpts = torch.where(valid[..., None], kpts, u * size[:, None, :].to(kpts.dtype))
            scores = torch.where(valid, scores, torch.zeros_like(scores))
            valid = torch.ones_like(valid)
        scales = torch.full((B, k), float(c.patch_scale), device=image.device)
        if c.upright:
            oris = torch.zeros((B, k), device=image.device)
        else:
            oris = dominant_orientation(extract_patches(gray, kpts, scales, torch.zeros_like(scales)))
        patches = extract_patches(gray, kpts, scales, oris)
        mu = patches.mean(dim=(2, 3), keepdim=True)
        sd = patches.std(dim=(2, 3), keepdim=True, correction=0) + 1e-6
        desc = self.descriptor.descriptor(((patches - mu) / sd).reshape(B * k, 1, PATCH, PATCH), train)
        return {
            "keypoints": kpts,
            "keypoint_scores": scores,
            "scales": scales,
            "oris": oris,
            "descriptors": desc.reshape(B, k, 128),
            "keypoint_mask": valid,
        }

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError("KeyNet + HardNet is evaluation-only, as in the JAX package")
