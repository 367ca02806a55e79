"""LoFTR, the dense detector-free matcher, for evaluation (counterpart of
`gluefactory_tpu/models/matchers/loftr.py`).

The ResNet-FPN backbone (`backbones/resnet_fpn.py`) gives 1/8 coarse and
1/2 fine maps; the coarse maps, plus the 1-indexed sine position encoding,
go through `coarse_layers` x (self + cross) encoder layers with linear
attention (elu(x) + 1 feature maps); dual-softmax coarse matching with a
border removal, mutual max and confidence threshold keeps the best
`max_num_matches` cells; each match's 5 x 5 fine windows, merged with its
coarse features, go through `fine_layers` x (self + cross) layers, and the
correlation's soft-argmax moves the match in image 1 by a sub-cell offset.

Static shapes as in the JAX package: exactly `max_num_matches` slots with
a validity mask, in the aligned-list contract (keypoints0/1 and arange
matches), so the eval pipelines treat it as a sparse matcher. The coarse
similarity and the fine correlation are dense products (`torch.matmul`).

Parameters carry the official names (`backbone.*`,
`loftr_coarse.layers.{i}.{q_proj,k_proj,v_proj,merge,mlp.0,mlp.2,norm1,
norm2}`, `loftr_fine.layers.{i}.*`, `fine_preprocess.{down_proj,
merge_feat}`), so the official checkpoint's state dict loads, and
`compat/jax_params.py` converts the JAX package's parameters. As in the JAX
package, the encoder layers' LayerNorms use flax's eps of 1e-6 (the
official 1e-5). Evaluation only: `loss` raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.resnet_fpn import ResNetFPN_8_2
from ..base_model import BaseModel


def sine_pos_encoding(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """The official PositionEncodingSine at (H, W, dim): sin / cos of the
    1-indexed x and y positions at dim / 4 frequencies, interleaved."""
    d4 = dim // 4
    ys = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None, None]
    xs = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :, None]
    div = torch.exp(torch.arange(d4, dtype=torch.float32, device=device) * 2.0
                    * (-math.log(10000.0) / (dim // 2)))
    pe = torch.zeros((h, w, dim), dtype=torch.float32, device=device)
    pe[..., 0::4] = torch.sin(xs * div).expand(h, w, d4)
    pe[..., 1::4] = torch.cos(xs * div).expand(h, w, d4)
    pe[..., 2::4] = torch.sin(ys * div).expand(h, w, d4)
    pe[..., 3::4] = torch.cos(ys * div).expand(h, w, d4)
    return pe


def linear_attention(q, k, v, mask_q=None, mask_kv=None):
    """O(N) attention with the feature map elu(x) + 1 (the official
    LinearAttention). q / k / v: (B, N, H, D)."""
    q = F.elu(q) + 1.0
    k = F.elu(k) + 1.0
    if mask_kv is not None:
        k = k * mask_kv[:, :, None, None]
        v = v * mask_kv[:, :, None, None]
    v_len = v.shape[1]
    v = v / v_len
    kv = torch.einsum("bnhd,bnhe->bhde", k, v)
    z = 1.0 / (torch.einsum("bnhd,bhd->bnh", q, k.sum(dim=1)) + 1e-6)
    # two operands at a time: torch's three-operand einsum runs a gemv per (b, n, h)
    out = torch.einsum("bnhd,bhde->bnhe", q, kv) * z[..., None] * v_len
    if mask_q is not None:
        out = out * mask_q[:, :, None, None]
    return out


class LoFTREncoderLayer(nn.Module):
    """merge(attention) -> norm1 -> mlp([x, message]) -> norm2 -> residual."""

    def __init__(self, dim: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.merge = nn.Linear(dim, dim, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * dim, 2 * dim, bias=False), nn.ReLU(),
                                 nn.Linear(2 * dim, dim, bias=False))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, source, mask_x=None, mask_src=None):
        B, N, D = x.shape
        H = self.nhead
        q = self.q_proj(x).reshape(B, N, H, D // H)
        k = self.k_proj(source).reshape(B, source.shape[1], H, D // H)
        v = self.v_proj(source).reshape(B, source.shape[1], H, D // H)
        msg = self.norm1(self.merge(linear_attention(q, k, v, mask_x, mask_src).reshape(B, N, D)))
        return x + self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))


class LocalFeatureTransformer(nn.Module):
    """`layers`: (self, cross) pairs of encoder layers; both views go
    through each layer, the cross layer's inputs taken before its update."""

    def __init__(self, dim: int, nhead: int, n_pairs: int):
        super().__init__()
        self.layers = nn.ModuleList(LoFTREncoderLayer(dim, nhead) for _ in range(2 * n_pairs))

    def forward(self, f0, f1):
        for i in range(0, len(self.layers), 2):
            f0 = self.layers[i](f0, f0)
            f1 = self.layers[i](f1, f1)
            f0, f1 = self.layers[i + 1](f0, f1), self.layers[i + 1](f1, f0)
        return f0, f1


class FinePreprocess(nn.Module):
    def __init__(self, dim_coarse: int, dim_fine: int):
        super().__init__()
        self.down_proj = nn.Linear(dim_coarse, dim_fine, bias=True)
        self.merge_feat = nn.Linear(2 * dim_fine, dim_fine, bias=True)


def _border_mask(h: int, w: int, b: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return ((ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)).reshape(-1)


def _windows(fmap: torch.Tensor, idx: torch.Tensor, wc: int, size: int) -> torch.Tensor:
    """(B, K, size, size, D) windows of the fine map (B, Hf, Wf, D) around
    each coarse cell's centre (fine coordinates idx // wc * 4 + 2, idx % wc
    * 4 + 2), cut from the map zero-padded by size // 2 with the start
    clamped into it, as `dynamic_slice` clamps."""
    r = size // 2
    B, Hf, Wf, _ = fmap.shape
    pad = F.pad(fmap, (0, 0, r, r, r, r))
    cy = ((idx // wc) * 4 + 2).clamp(0, Hf + 2 * r - size)
    cx = ((idx % wc) * 4 + 2).clamp(0, Wf + 2 * r - size)
    steps = torch.arange(size, device=fmap.device)
    b = torch.arange(B, device=fmap.device)[:, None, None, None]
    return pad[b, (cy[..., None] + steps)[..., :, None], (cx[..., None] + steps)[..., None, :]]


class LoFTR(BaseModel):
    default_conf = {
        "coarse_layers": 4,  # x (self + cross)
        "fine_layers": 1,
        "dim_coarse": 256,
        "dim_fine": 128,
        "nhead": 8,
        "temperature": 0.1,
        "match_threshold": 0.2,
        "border_rm": 2,  # coarse cells removed at each border
        "max_num_matches": 1024,  # static match slots
        "fine_window": 5,
        "fine_concat_coarse": True,
        "weights": None,
        "trainable": False,
    }
    required_data_keys = ["view0", "view1"]

    def _init(self, conf):
        self.backbone = ResNetFPN_8_2()
        self.loftr_coarse = LocalFeatureTransformer(conf.dim_coarse, conf.nhead, conf.coarse_layers)
        self.loftr_fine = LocalFeatureTransformer(conf.dim_fine, conf.nhead, conf.fine_layers)
        if conf.fine_concat_coarse:
            self.fine_preprocess = FinePreprocess(conf.dim_coarse, conf.dim_fine)

    def _forward(self, data: dict, train: bool = False) -> dict:
        c = self.conf
        imgs = [data["view0"]["image"], data["view1"]["image"]]
        if imgs[0].shape[-1] == 3:
            w = torch.tensor([0.299, 0.587, 0.114], dtype=imgs[0].dtype, device=imgs[0].device)
            imgs = [(im * w).sum(-1, keepdim=True) for im in imgs]
        B = imgs[0].shape[0]
        dev = imgs[0].device
        feats = [self.backbone(im.permute(0, 3, 1, 2), train=train) for im in imgs]
        coarse = [f[0].permute(0, 2, 3, 1) for f in feats]  # (B, Hc, Wc, Dc)
        fine = [f[1].permute(0, 2, 3, 1) for f in feats]  # (B, Hf, Wf, Df)
        (Hc0, Wc0), (Hc1, Wc1) = coarse[0].shape[1:3], coarse[1].shape[1:3]

        # the f32 sine tables in the features' dtype, as the JAX package casts them
        f0, f1 = ((cf + sine_pos_encoding(h, w_, c.dim_coarse, dev).to(cf.dtype)).reshape(B, h * w_, -1)
                  for cf, (h, w_) in zip(coarse, ((Hc0, Wc0), (Hc1, Wc1))))
        f0, f1 = self.loftr_coarse(f0, f1)

        # dual-softmax coarse matching: both features scaled by C^-0.5 (net 1 / C)
        sim = torch.matmul((f0 * (1.0 / c.dim_coarse)).float(), f1.float().transpose(1, 2)) / c.temperature
        P = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)
        P = P * _border_mask(Hc0, Wc0, c.border_rm, dev)[None, :, None]
        P = P * _border_mask(Hc1, Wc1, c.border_rm, dev)[None, None, :]
        mutual = (P == P.amax(dim=2, keepdim=True)) & (P == P.amax(dim=1, keepdim=True))
        cand = torch.where(mutual & (P > c.match_threshold), P, torch.zeros((), device=dev))
        best_p, best_j = cand.max(dim=2)
        del sim, P, mutual, cand

        K = int(c.max_num_matches)
        scores, top_i = torch.topk(best_p, K, dim=1)
        top_j = torch.gather(best_j, 1, top_i)
        valid = scores > 0

        def cell_xy(idx, wc):
            return torch.stack([(idx % wc).float(), (idx // wc).float()], -1)

        kpts0 = (cell_xy(top_i, Wc0) + 0.5) * 8.0
        kpts1_c = (cell_xy(top_j, Wc1) + 0.5) * 8.0

        # fine refinement on the 5 x 5 windows of the 1/2 maps
        W_f = int(c.fine_window)
        r = W_f // 2
        w0 = _windows(fine[0], top_i, Wc0, W_f).reshape(B * K, W_f * W_f, c.dim_fine)
        w1 = _windows(fine[1], top_j, Wc1, W_f).reshape(B * K, W_f * W_f, c.dim_fine)
        if c.fine_concat_coarse:
            sel0 = torch.gather(f0, 1, top_i[..., None].expand(B, K, f0.shape[-1])).reshape(B * K, 1, -1)
            sel1 = torch.gather(f1, 1, top_j[..., None].expand(B, K, f1.shape[-1])).reshape(B * K, 1, -1)
            cc = self.fine_preprocess.down_proj(torch.cat([sel0, sel1], dim=0))
            wcat = torch.cat([w0, w1], dim=0)
            merged = self.fine_preprocess.merge_feat(
                torch.cat([wcat, cc.expand(-1, W_f * W_f, -1)], dim=-1))
            w0, w1 = merged[:B * K], merged[B * K:]
        w0, w1 = self.loftr_fine(w0, w1)

        # correlation of w0's centre with w1, soft-argmax (the official FineMatching)
        centre = w0[:, (W_f * W_f) // 2]
        heat = torch.matmul(w1.float(), centre.float()[:, :, None])[..., 0] / (c.dim_fine**0.5)
        prob = torch.softmax(heat, dim=-1).reshape(-1, W_f, W_f)
        g = torch.arange(W_f, dtype=torch.float32, device=dev) - r
        ex = (prob.sum(1) * g).sum(-1)
        ey = (prob.sum(2) * g).sum(-1)
        kpts1 = kpts1_c + torch.stack([ex, ey], -1).reshape(B, K, 2) * 2.0  # fine maps at stride 2

        arange = torch.arange(K, device=dev)[None].expand(B, K)
        matches = torch.where(valid, arange, torch.full_like(arange, -1))
        scoresm = torch.where(valid, scores, torch.zeros((), device=dev))
        return {
            "keypoints0": kpts0,
            "keypoints1": kpts1,
            "keypoint_scores0": scoresm,
            "keypoint_scores1": scoresm,
            "keypoint_mask0": valid,
            "keypoint_mask1": valid,
            "matches0": matches,
            "matches1": matches,
            "matching_scores0": scoresm,
            "matching_scores1": scoresm,
        }

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError("LoFTR is eval-only (as in the JAX package and the reference)")
