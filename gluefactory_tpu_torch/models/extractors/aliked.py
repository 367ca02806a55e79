"""ALIKED: a keypoint detector with deformable convolutions and a sparse
deformable descriptor head (counterpart of
`gluefactory_tpu/models/extractors/aliked.py`).

Parameters carry the official names (`aliked-n16.pth` and its siblings):
`block{1..4}.conv{1,2}` (`offset_conv` / `regular_conv` in the deformable
blocks 3 and 4), `block{1..4}.bn{1,2}`, `block{2..4}.downsample`,
`conv{1..4}`, `score_head.{0,2,4,6}`, `desc_head.offset_conv.{0,2}`,
`desc_head.sf_conv` and `desc_head.agg_weights`. The network runs
channels-first; the data contract is the JAX package's: images (B, H, W, C)
in [0, 1], keypoints in the COLMAP convention (+0.5), exactly
`max_num_keypoints` of them with a `keypoint_mask`, and the
`score_dispersity` and `score_map` beside them.

The deformable convolution is K x K bilinear gathers at the offset
positions (zeros outside) and one matrix product over (tap, C_in), as the
JAX package computes it (`deform_conv2d`). BatchNorm follows the `train`
argument and nothing else, as the JAX model's (`use_running_average=not
train`, flax's momentum 0.99): in a training step the frozen extractor
normalises by the stacked views' batch and moves its running statistics
(`ops/batch_norm.py`); `freeze_batch_normalization` changes nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.batch_norm import batch_norm
from ...ops.grid_sample import grid_sample_nd
from ...ops.nms import simple_nms, top_k_keypoints
from ...utils.distributed import batch_rand
from ..base_model import BaseModel

CFGS = {
    "aliked-t16": {"c1": 8, "c2": 16, "c3": 32, "c4": 64, "dim": 64, "K": 3, "M": 16},
    "aliked-n16": {"c1": 16, "c2": 32, "c3": 64, "c4": 128, "dim": 128, "K": 3, "M": 16},
    "aliked-n16rot": {"c1": 16, "c2": 32, "c3": 64, "c4": 128, "dim": 128, "K": 3, "M": 16},
    "aliked-n32": {"c1": 16, "c2": 32, "c3": 64, "c4": 128, "dim": 128, "K": 3, "M": 32},
}
BN_MOMENTUM = 0.99  # flax's default, the JAX model's


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  max_offset: float) -> torch.Tensor:
    """Deformable K x K convolution without bias. x (B, Cin, H, W); offsets
    (B, 2*K*K, H, W), per tap in row-major order [dy, dx], clamped to
    +-max_offset; weight (Cout, Cin, K, K). Each tap samples x bilinearly
    at (y + ky - K//2 + dy, x + kx - K//2 + dx), zeros outside. Returns
    (B, Cout, H, W)."""
    B, C, H, W = x.shape
    K = weight.shape[-1]
    off = offsets.clamp(-max_offset, max_offset).permute(0, 2, 3, 1).reshape(B, H, W, K * K, 2)
    ys = torch.arange(H, dtype=torch.float32, device=x.device)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=x.device)[None, :, None]
    taps = torch.arange(K * K, device=x.device)
    ky = (taps // K - K // 2).float()
    kx = (taps % K - K // 2).float()
    py = ys + ky + off[..., 0]  # (B, H, W, K*K)
    px = xs + kx + off[..., 1]
    pts = torch.stack([px + 0.5, py + 0.5], dim=-1).reshape(B, H * W * K * K, 2)
    sampled = grid_sample_nd(x.permute(0, 2, 3, 1), pts).reshape(B, H * W, K * K * C)
    w = weight.permute(2, 3, 1, 0).reshape(K * K * C, -1)  # rows (tap, Cin)
    out = sampled @ w
    return out.reshape(B, H, W, -1).permute(0, 3, 1, 2)


class DeformableConv2d(nn.Module):
    """The official DeformableConv2d without modulation: `offset_conv`
    (K x K, with bias) predicts the offsets, `regular_conv` (bias-free)
    holds the weights applied at the offset positions."""

    def __init__(self, c_in: int, c_out: int, K: int = 3):
        super().__init__()
        self.offset_conv = nn.Conv2d(c_in, 2 * K * K, K, padding=K // 2, bias=True)
        self.regular_conv = nn.Conv2d(c_in, c_out, K, padding=K // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        max_offset = max(x.shape[2], x.shape[3]) / 4.0
        return deform_conv2d(x, self.offset_conv(x), self.regular_conv.weight, max_offset)


def _conv(c_in: int, c_out: int, dcn: bool) -> nn.Module:
    return DeformableConv2d(c_in, c_out) if dcn else nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """conv -> BN -> SELU, twice."""

    def __init__(self, c_in: int, c_out: int, dcn: bool = False):
        super().__init__()
        self.conv1 = _conv(c_in, c_out, dcn)
        self.bn1 = nn.BatchNorm2d(c_out)
        self.conv2 = _conv(c_out, c_out, dcn)
        self.bn2 = nn.BatchNorm2d(c_out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.selu(batch_norm(self.bn1, self.conv1(x), train, BN_MOMENTUM))
        return F.selu(batch_norm(self.bn2, self.conv2(x), train, BN_MOMENTUM))


class ResBlock(ConvBlock):
    """ConvBlock whose second SELU takes the sum with a 1x1 projection of
    the input (`downsample`, with bias)."""

    def __init__(self, c_in: int, c_out: int, dcn: bool = False):
        super().__init__(c_in, c_out, dcn)
        self.downsample = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        identity = self.downsample(x)
        y = F.selu(batch_norm(self.bn1, self.conv1(x), train, BN_MOMENTUM))
        y = batch_norm(self.bn2, self.conv2(y), train, BN_MOMENTUM)
        return F.selu(y + identity)


class SDDH(nn.Module):
    """Sparse deformable descriptor head: the K x K patch of the feature map
    at each keypoint predicts M sample offsets (a valid K x K conv, SELU, a
    1x1 conv, clamped); the map is sampled bilinearly at the float keypoint
    plus each offset, passed through `sf_conv` (1x1, bias-free) and SELU,
    and aggregated by `agg_weights` (M, C, dim); L2-normalised."""

    def __init__(self, dim: int, K: int = 3, M: int = 16):
        super().__init__()
        self.K, self.M = K, M
        self.offset_conv = nn.Sequential(nn.Conv2d(dim, 2 * M, K, bias=True), nn.SELU(),
                                         nn.Conv2d(2 * M, 2 * M, 1, bias=True))
        self.sf_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.agg_weights = nn.Parameter(torch.rand(M, dim, dim))

    def forward(self, fmap: torch.Tensor, kpts_idx: torch.Tensor) -> torch.Tensor:
        """fmap (B, H, W, C); kpts_idx (B, N, 2) array-index (x, y). Returns
        (B, N, dim)."""
        feats = self.sample_features(fmap, kpts_idx)
        B, N, M, C = feats.shape
        desc = feats.reshape(B, N, M * C) @ self.agg_weights.reshape(M * C, -1)
        return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-12)

    def sample_features(self, fmap: torch.Tensor, kpts_idx: torch.Tensor) -> torch.Tensor:
        """The M features of each keypoint, after `sf_conv` and SELU, that
        `agg_weights` aggregates: (B, N, M, C)."""
        B, H, W, C = fmap.shape
        N = kpts_idx.shape[1]
        K, M = self.K, self.M
        max_offset = max(H, W) / 4.0
        # the patch's corner: floor(kpt) - K//2, clamped to [0, size - 1 - K]
        # (the official clamp's bound, one short of size - K)
        corner = torch.floor(kpts_idx).long() - K // 2
        cx = corner[..., 0].clamp(0, W - 1 - K)
        cy = corner[..., 1].clamp(0, H - 1 - K)
        offs = torch.arange(K, device=fmap.device)
        lin = ((cy[..., None, None] + offs[:, None]) * W + cx[..., None, None] + offs[None, :])
        patch = torch.gather(fmap.reshape(B, H * W, C), 1,
                             lin.reshape(B, N * K * K, 1).expand(-1, -1, C))
        patch = patch.reshape(B * N, K, K, C).permute(0, 3, 1, 2).reshape(B * N, C * K * K)
        conv1, conv2 = self.offset_conv[0], self.offset_conv[2]
        out = F.selu(F.linear(patch, conv1.weight.reshape(2 * M, -1), conv1.bias))
        out = F.linear(out, conv2.weight[:, :, 0, 0], conv2.bias)
        out = out.clamp(-max_offset, max_offset).reshape(B, N, 2, M)
        offset = out.transpose(2, 3)  # (B, N, M, [x, y]): first M x, then M y
        pos = kpts_idx[:, :, None, :] + offset
        feats = grid_sample_nd(fmap, (pos + 0.5).reshape(B, N * M, 2)).reshape(B, N, M, C)
        return F.selu(F.linear(feats, self.sf_conv.weight[:, :, 0, 0]))


class ALIKED(BaseModel):
    default_conf = {
        "model_name": "aliked-n16",
        "max_num_keypoints": 2048,
        "detection_threshold": 0.2,
        "force_num_keypoints": False,
        "nms_radius": 2,
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        cfg = CFGS[conf.model_name]
        self.block1 = ConvBlock(3, cfg["c1"])
        self.block2 = ResBlock(cfg["c1"], cfg["c2"])
        self.block3 = ResBlock(cfg["c2"], cfg["c3"], dcn=True)
        self.block4 = ResBlock(cfg["c3"], cfg["dim"], dcn=True)
        d4 = cfg["dim"] // 4
        self.conv1 = nn.Conv2d(cfg["c1"], d4, 1, bias=False)
        self.conv2 = nn.Conv2d(cfg["c2"], d4, 1, bias=False)
        self.conv3 = nn.Conv2d(cfg["c3"], d4, 1, bias=False)
        self.conv4 = nn.Conv2d(cfg["dim"], d4, 1, bias=False)
        self.score_head = nn.Sequential(
            nn.Conv2d(cfg["dim"], 8, 1, bias=False), nn.SELU(),
            nn.Conv2d(8, 4, 3, padding=1, bias=False), nn.SELU(),
            nn.Conv2d(4, 4, 3, padding=1, bias=False), nn.SELU(),
            nn.Conv2d(4, 1, 3, padding=1, bias=False),
        )
        self.desc_head = SDDH(cfg["dim"], cfg["K"], cfg["M"])

    def extract_dense_map(self, image: torch.Tensor, train: bool = False):
        """image (B, H, W, C) -> (feature map (B, H, W, dim), L2-normalised,
        score map (B, H, W) after the sigmoid)."""
        B, H, W, C = image.shape
        x = image.permute(0, 3, 1, 2)
        if C == 1:
            x = x.expand(B, 3, H, W)
        # replicate padding to a multiple of 32, split before and after
        ph, pw = -H % 32, -W % 32
        t, left = ph // 2, pw // 2
        if ph or pw:
            x = F.pad(x, (left, pw - left, t, ph - t), mode="replicate")
        x1 = self.block1(x, train)
        x2 = self.block2(F.avg_pool2d(x1, 2), train)
        x3 = self.block3(F.avg_pool2d(x2, 4), train)
        x4 = self.block4(F.avg_pool2d(x3, 4), train)
        Hp, Wp = x.shape[2:]
        f1 = F.selu(self.conv1(x1))
        # bilinear with align_corners: output index i samples input i * (in - 1) / (out - 1)
        up = [F.interpolate(F.selu(conv(xi)), size=(Hp, Wp), mode="bilinear", align_corners=True)
              for conv, xi in ((self.conv2, x2), (self.conv3, x3), (self.conv4, x4))]
        fmap = torch.cat([f1, *up], dim=1)
        score = torch.sigmoid(self.score_head(fmap))[:, 0]
        fmap = fmap / (torch.linalg.vector_norm(fmap, dim=1, keepdim=True) + 1e-12)
        fmap = fmap[:, :, t:t + H, left:left + W].permute(0, 2, 3, 1)
        return fmap, score[:, t:t + H, left:left + W]

    def _dkd_refine(self, kpts_int: torch.Tensor, score_map: torch.Tensor):
        """The soft-argmax refinement of integer array-index keypoints (B, N,
        2): a temperature-0.1 softmax over the (2r+1)^2 window of the raw
        score map (zeros outside). Returns (refined array-index keypoints,
        the score map sampled bilinearly there, dispersity)."""
        r = int(self.conf.nms_radius)
        B, H, W = score_map.shape
        N = kpts_int.shape[1]
        d = 2 * r + 1
        offs = torch.arange(-r, r + 1, device=score_map.device)
        gy = kpts_int[..., 1, None, None] + offs[:, None]  # (B, N, d, 1)
        gx = kpts_int[..., 0, None, None] + offs[None, :]  # (B, N, 1, d)
        valid = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
        lin = (gy.clamp(0, H - 1) * W + gx.clamp(0, W - 1)).reshape(B, N * d * d)
        patch = torch.gather(score_map.reshape(B, H * W), 1, lin).reshape(B, N, d, d)
        patch = (patch * valid).reshape(B, N, d * d)
        x_exp = torch.exp((patch - patch.max(dim=-1, keepdim=True).values) / 0.1)
        grid_x = offs.float().repeat(d)
        grid_y = offs.float().repeat_interleave(d)
        denom = x_exp.sum(-1)
        rx = (x_exp @ grid_x) / denom
        ry = (x_exp @ grid_y) / denom
        dist2 = ((grid_x - rx[..., None]) ** 2 + (grid_y - ry[..., None]) ** 2) / (r * r)
        dispersity = (x_exp * dist2).sum(-1) / denom
        refined = kpts_int.float() + torch.stack([rx, ry], dim=-1)
        kscore = grid_sample_nd(score_map[..., None], refined + 0.5)[..., 0]
        return refined, kscore, dispersity

    def _forward(self, data: dict, generator: torch.Generator | None = None,
                 train: bool = False) -> dict:
        """`generator` draws the random keypoints that fill invalid slots
        under `force_num_keypoints` (a fresh one seeded with 0 if None)."""
        c = self.conf
        image = data["image"]
        B, H, W, _ = image.shape
        fmap, score_map = self.extract_dense_map(image, train)

        r = int(c.nms_radius)
        nmsed = simple_nms(score_map, r)
        # border removal: r-wide margins inside the true image area
        xs = torch.arange(W, dtype=torch.float32, device=image.device)[None, None, :]
        ys = torch.arange(H, dtype=torch.float32, device=image.device)[None, :, None]
        true_size = data.get("image_size")
        if true_size is not None:
            ts = true_size.to(torch.float32)
            wt, ht = ts[:, 0, None, None], ts[:, 1, None, None]
        else:
            wt, ht = float(W), float(H)
        in_area = (xs >= r) & (ys >= r) & (xs < wt - r) & (ys < ht - r)
        nmsed = torch.where(in_area, nmsed, torch.zeros_like(nmsed))

        k = int(c.max_num_keypoints)
        kpts, scores, valid = top_k_keypoints(nmsed, k, max(c.detection_threshold, 0.0))
        kpts_int = torch.round(kpts - 0.5).long()
        refined, kscore, dispersity = self._dkd_refine(kpts_int, score_map)
        kpts = refined + 0.5
        scores = torch.where(valid, kscore, torch.zeros_like(kscore))
        if c.force_num_keypoints:
            if generator is None:
                generator = torch.Generator(device=image.device).manual_seed(0)
            size = true_size
            if size is None:
                size = torch.tensor([[W, H]], dtype=torch.float32, device=image.device).expand(B, 2)
            u = batch_rand((B, k, 2), generator, image.device, kpts.dtype)
            kpts = torch.where(valid[..., None], kpts, u * size[:, None, :].to(kpts.dtype))
            valid = torch.ones_like(valid)
        desc = self.desc_head(fmap, kpts - 0.5)
        return {
            "keypoints": kpts,
            "keypoint_scores": scores,
            "keypoint_mask": valid,
            "descriptors": desc,
            "score_dispersity": dispersity,
            "score_map": score_map,
        }

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError
