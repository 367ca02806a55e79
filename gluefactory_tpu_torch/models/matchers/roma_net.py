"""The RoMa dense-warp regression network (counterpart of
`gluefactory_tpu/models/matchers/roma_net.py`):

  - coarse encoder: DINOv2 ViT-L/14 patch features (`backbones/dinov2.py`),
    the "16" level of the pyramid;
  - fine encoder: VGG19-BN, the map just before each of the first four
    max-pools (scales 1, 2, 4, 8);
  - coarse matcher: a Gaussian-process posterior mean with a cosine kernel
    (T = 0.2) over Fourier-embedded support coordinates, mu = K_xy (K_yy +
    0.1 I)^-1 F, then a pre-norm ViT over [mu ; proj(f_A)] tokens that
    classifies each coarse cell into a K x K anchor grid plus a certainty
    logit; anchors decode to flow by a soft-argmax over the mode and its
    four neighbours;
  - refiners: per scale, depthwise 5 x 5 conv, BatchNorm, ReLU and 1 x 1
    conv blocks over [f_A ; f_B warped ; displacement embedding ; local
    correlation], predicting a flow and a certainty delta.

Both warp directions run as one doubled batch (the first half A -> B, the
second B -> A), and both images through the encoders at once. Feature maps
are channels-first here; flows and certainties keep the JAX package's
(B, H, W, 2) / (B, H, W). Every bilinear resize antialiases when it
downsamples, as `jax.image.resize(..., "linear")` does
(`F.interpolate(..., antialias=True)`). The local correlation is computed
one window offset at a time, so that its (B, H, W, (2r + 1)^2, C) window
stack is never held. Inference only: the BatchNorms use their running
statistics.

Parameters carry romatch's names (`encoder.cnn.layers.{i}` at torchvision's
`vgg19_bn().features` indices, `encoder.dinov2.*`, `decoder.gps.16.pos_conv`,
`decoder.proj.{s}.{0,1}`, `decoder.conv_refiner.{s}.{block1, hidden_blocks.{j}}
.{0,1,3}`, `.out_conv`, `.disp_emb`, `decoder.embedding_decoder.blocks.{i}.*`
with a fused `attn.qkv`, `.to_out`), the layout the JAX package's
`convert_roma` reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.config import Config
from ...ops.batch_norm import batch_norm
from ..backbones.dinov2 import VIT_CONFS, Attention, DinoV2, Mlp

# torchvision vgg19_bn `features` conv indices per block (BatchNorm at i + 1)
VGG19_BLOCKS = (
    (64, (0, 3)),
    (128, (7, 10)),
    (256, (14, 17, 20, 23)),
    (512, (27, 30, 33, 36)),
)

NET_DEFAULT_CONF = {
    # coarse (scale-16 slot) encoder: the DinoV2 backbone's conf
    "dinov2": {
        "weights": "dinov2_vitl14",
        "trainable": False,
        "embed_dim": None,  # override for narrow tests
        "depth": None,
        "num_heads": None,
    },
    # fine encoder: [channels, n_convs] per VGG block (scales 1, 2, 4, 8)
    "vgg_blocks": [[64, 2], [128, 2], [256, 4], [512, 4]],
    "gp_dim": 512,
    "gp_temperature": 0.2,
    "gp_sigma_noise": 0.1,
    "decoder_blocks": 5,
    "decoder_heads": 8,
    "anchor_res": 64,  # K x K regression-by-classification anchor grid
    # per-scale decoder hyperparameters
    "proj_dims": {"16": 512, "8": 512, "4": 256, "2": 64, "1": 9},
    "disp_emb_dims": {"16": 128, "8": 64, "4": 32, "2": 16, "1": 6},
    "corr_radius": {"16": 7, "8": 3, "4": 2, "2": None, "1": None},
    "hidden_blocks": 8,
    "kernel_size": 5,
    "detach_between_scales": True,
}
SCALES = ("16", "8", "4", "2", "1")


def _grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) [x, y] grid at linspace(-1 + 1/n, 1 - 1/n, n): pixel
    centres, align_corners False."""
    ys = torch.linspace(-1.0 + 1.0 / h, 1.0 - 1.0 / h, h, device=device)
    xs = torch.linspace(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w, device=device)
    return torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)


def sample_normalized(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of fmap (B, C, H, W) at normalised [-1, 1] coords
    (B, h, w, 2): (B, C, h, w); torch's grid_sample, align_corners False,
    zeros outside."""
    return F.grid_sample(fmap, coords.to(fmap.dtype), mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear, align_corners False, antialiased on a downsample (as
    `jax.image.resize(..., "linear")`) resize of the last two axes of a
    (B, C, H, W) or (B, H, W) tensor."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    squeeze = x.ndim == 3
    y = F.interpolate(x[:, None] if squeeze else x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    return y[:, 0] if squeeze else y


def cls_to_flow_refine(logits: torch.Tensor) -> torch.Tensor:
    """Anchor classification -> flow: softmax over the K^2 anchors, then a
    soft-argmax over the mode (the first maximum) and its 4 neighbours in
    the flattened grid (crossing row ends, clipped to [0, K^2 - 1]).

    logits (B, H, W, K^2) -> flow (B, H, W, 2) in [-1, 1]."""
    K2 = logits.shape[-1]
    res = int(round(math.sqrt(K2)))
    if res * res != K2:
        raise ValueError(f"anchor channels {K2} not a square")
    anchors = _grid(res, res, logits.device).reshape(K2, 2)
    probs = torch.softmax(logits, dim=-1)
    mode = torch.argmax(probs, dim=-1)
    nbr = torch.stack([mode - 1, mode, mode + 1, mode - res, mode + res], dim=-1).clamp(0, K2 - 1)
    p = torch.gather(probs, -1, nbr)
    coords = anchors[nbr]  # (B, H, W, 5, 2)
    return (p[..., None] * coords).sum(-2) / (p.sum(-1, keepdim=True) + 1e-8)


def local_correlation(f_a: torch.Tensor, f_b: torch.Tensor, radius: int, flow: torch.Tensor) -> torch.Tensor:
    """Correlation of each f_a pixel with a (2r + 1)^2 window of f_b
    sampled around the flow (one f_b pixel a step in normalised units),
    products scaled by 1 / sqrt(C); one window offset at a time.

    f_a, f_b (B, C, H, W); flow (B, H, W, 2) -> (B, K, H, W), offsets in
    row-major (y, x) order."""
    B, C, H, W = f_a.shape
    k = 2 * radius + 1
    oy = torch.linspace(-2.0 * radius / H, 2.0 * radius / H, k, device=flow.device)
    ox = torch.linspace(-2.0 * radius / W, 2.0 * radius / W, k, device=flow.device)
    offs = torch.stack(torch.meshgrid(ox, oy, indexing="xy"), dim=-1).reshape(-1, 2)
    out = torch.empty((B, k * k, H, W), dtype=f_a.dtype, device=f_a.device)
    for i in range(k * k):
        window = sample_normalized(f_b, flow + offs[i])
        out[:, i] = (f_a * window).sum(1)
    return out / math.sqrt(C)


class VGG19(nn.Module):
    """VGG19-BN fine pyramid: `layers` at torchvision's `features` indices
    (conv at i, BatchNorm at i + 1; the other slots hold no parameters)."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = tuple(idxs for _, idxs in blocks)
        mods: dict = {}
        c_in = 3
        for ch, idxs in blocks:
            for i in idxs:
                mods[i] = nn.Conv2d(c_in, ch, 3, padding=1)
                mods[i + 1] = nn.BatchNorm2d(ch, eps=1e-5)
                c_in = ch
        self.layers = nn.ModuleList(mods.get(i, nn.Identity()) for i in range(max(mods) + 1))

    def forward(self, x: torch.Tensor) -> dict:
        """x (B, 3, H, W) -> {scale: (B, C, H / scale, W / scale)}."""
        feats = {}
        for n, idxs in enumerate(self.blocks):
            if n:
                x = F.max_pool2d(x, 2, 2)
            for i in idxs:
                x = F.relu(batch_norm(self.layers[i + 1], self.layers[i](x), False, 0.9))
            feats[2 ** n] = x
        return feats


class Encoder(nn.Module):
    def __init__(self, conf: Config):
        super().__init__()
        self.cnn = VGG19([(int(ch), VGG19_BLOCKS[i][1][:int(n)]) for i, (ch, n) in enumerate(conf.vgg_blocks)])
        self.dinov2 = DinoV2(DinoV2.resolve_conf(conf.dinov2.to_dict()))

    def forward(self, image: torch.Tensor, coarse: bool = True) -> dict:
        """image (B, 3, H, W), ImageNet-normalised -> {scale: (B, C, h, w)}."""
        feats = self.cnn(image)
        if coarse:
            feats[16] = self.dinov2({"image": image.permute(0, 2, 3, 1)})["features"].permute(0, 3, 1, 2)
        return feats


class GP(nn.Module):
    """Cosine-kernel GP posterior mean over Fourier-embedded support
    coordinates (kernel K(x, y) = exp((cos(x, y) - 1) / T))."""

    def __init__(self, gp_dim: int, temperature: float = 0.2, sigma_noise: float = 0.1):
        super().__init__()
        self.temperature, self.sigma_noise = temperature, sigma_noise
        self.pos_conv = nn.Conv2d(2, gp_dim, 1)

    def _kernel(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        c = torch.matmul(x, y.transpose(1, 2))
        nx = torch.linalg.vector_norm(x, dim=-1)
        ny = torch.linalg.vector_norm(y, dim=-1)
        c = c / (nx[:, :, None] * ny[:, None, :] + 1e-6)
        return torch.exp((c - 1.0) / self.temperature)

    def forward(self, f_a: torch.Tensor, f_b: torch.Tensor) -> torch.Tensor:
        B, C, h1, w1 = f_a.shape
        h2, w2 = f_b.shape[-2:]
        g = _grid(h2, w2, f_b.device).permute(2, 0, 1)[None]
        emb = torch.cos((8.0 * math.pi) * self.pos_conv(g))  # (1, gp_dim, h2, w2)
        f = emb.flatten(2).transpose(1, 2).expand(B, -1, -1).float()
        x = f_a.flatten(2).transpose(1, 2).float()
        y = f_b.flatten(2).transpose(1, 2).float()
        eye = torch.eye(h2 * w2, device=f_b.device)
        k_yy = self._kernel(y, y) + self.sigma_noise * eye[None]
        k_xy = self._kernel(x, y)
        mu = torch.matmul(k_xy, torch.linalg.solve(k_yy, f))
        return mu.transpose(1, 2).reshape(B, -1, h1, w1).to(f_a.dtype)


class ViTBlock(nn.Module):
    """Plain pre-norm transformer block (DINOv2's fused-qkv attention and
    4x GELU MLP, no LayerScale)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class AnchorDecoder(nn.Module):
    """ViT decoder over [gp posterior ; projected coarse features] tokens ->
    per-cell anchor classification (K^2 channels) and a certainty logit."""

    def __init__(self, dim: int, blocks: int, heads: int, anchor_res: int):
        super().__init__()
        self.blocks = nn.ModuleList(ViTBlock(dim, heads) for _ in range(blocks))
        self.to_out = nn.Linear(dim, anchor_res ** 2 + 1)

    def forward(self, x: torch.Tensor) -> tuple:
        """x (B, C, H, W) -> cls logits (B, H, W, K^2), certainty (B, H, W)."""
        B, C, H, W = x.shape
        t = x.flatten(2).transpose(1, 2)
        for blk in self.blocks:
            t = blk(t)
        out = self.to_out(t).reshape(B, H, W, -1)
        return out[..., :-1], out[..., -1]


def _refiner_block(dim: int, kernel_size: int) -> nn.Sequential:
    """Depthwise conv (groups = dim), BatchNorm, ReLU, 1 x 1 mixing conv."""
    return nn.Sequential(nn.Conv2d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim),
                         nn.BatchNorm2d(dim, eps=1e-5), nn.ReLU(), nn.Conv2d(dim, dim, 1))


class ConvRefiner(nn.Module):
    """Depthwise refiner blocks predicting (delta flow, delta certainty)
    from [f_A ; f_B warped ; displacement embedding ; local correlation]."""

    def __init__(self, hidden: int, disp_emb_dim: int, corr_radius, hidden_blocks: int, kernel_size: int = 5):
        super().__init__()
        self.corr_radius = corr_radius
        self.block1 = _refiner_block(hidden, kernel_size)
        self.hidden_blocks = nn.ModuleList(_refiner_block(hidden, kernel_size) for _ in range(hidden_blocks))
        self.out_conv = nn.Conv2d(hidden, 3, 1)
        self.disp_emb = nn.Conv2d(2, disp_emb_dim, 1)

    @staticmethod
    def _block(block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        return block[3](F.relu(batch_norm(block[1], block[0](x), False, 0.9)))

    def forward(self, f_a, f_b, flow, scale_factor: float = 1.0) -> tuple:
        """f_a, f_b (B, C, H, W), flow (B, H, W, 2) -> delta flow
        (B, H, W, 2), delta certainty (B, H, W)."""
        H, W = f_a.shape[-2:]
        b_warped = sample_normalized(f_b, flow)
        disp = (flow - _grid(H, W, flow.device)[None]).permute(0, 3, 1, 2)
        # displacement embeddings scaled by 40 / 32 * scale_factor
        emb = self.disp_emb((40.0 / 32.0 * scale_factor) * disp)
        parts = [f_a, b_warped, emb]
        if self.corr_radius:
            parts.append(local_correlation(f_a, f_b, self.corr_radius, flow))
        d = self._block(self.block1, torch.cat(parts, dim=1))
        for block in self.hidden_blocks:
            d = self._block(block, d)
        d = self.out_conv(d.float())
        return d[:, :2].permute(0, 2, 3, 1), d[:, 2]


class RoMaDecoder(nn.Module):
    """Coarse-to-fine warp decoder over the pyramid (scales 16 -> 1): the
    GP and the anchor decoder at the coarsest level, a ConvRefiner at every
    level, flow and certainty resized between levels."""

    def __init__(self, conf: Config):
        super().__init__()
        c = conf
        self.detach_between_scales = bool(c.detach_between_scales)
        vit_dim = c.dinov2.get("embed_dim") or VIT_CONFS[c.dinov2.weights]["embed_dim"]
        proj_in = {"16": int(vit_dim), **{s: int(c.vgg_blocks[i][0]) for i, s in enumerate(("1", "2", "4", "8"))}}
        self.gps = nn.ModuleDict({"16": GP(int(c.gp_dim), float(c.gp_temperature), float(c.gp_sigma_noise))})
        self.embedding_decoder = AnchorDecoder(int(c.gp_dim) + int(c.proj_dims["16"]), int(c.decoder_blocks),
                                               int(c.decoder_heads), int(c.anchor_res))
        self.proj = nn.ModuleDict({s: nn.Sequential(nn.Conv2d(proj_in[s], int(c.proj_dims[s]), 1),
                                                    nn.BatchNorm2d(int(c.proj_dims[s]), eps=1e-5))
                                   for s in SCALES})
        refiners = {}
        for s in SCALES:
            r = int(c.corr_radius[s]) if c.corr_radius[s] else None
            hidden = 2 * int(c.proj_dims[s]) + int(c.disp_emb_dims[s]) + ((2 * r + 1) ** 2 if r else 0)
            refiners[s] = ConvRefiner(hidden, int(c.disp_emb_dims[s]), r, int(c.hidden_blocks),
                                      int(c.kernel_size))
        self.conv_refiner = nn.ModuleDict(refiners)

    def _proj(self, s: str, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.proj[s]
        return batch_norm(bn, conv(x), False, 0.9)

    def forward(self, f_a: dict, f_b: dict, flow=None, certainty=None, upsample: bool = False,
                scale_factor: float = 1.0) -> dict:
        scales = SCALES[1:] if upsample else SCALES
        corresps: dict = {}
        for s in scales:
            ins = int(s)
            fa_s = self._proj(s, f_a[ins])
            fb_s = self._proj(s, f_b[ins])
            hs, ws = fa_s.shape[-2:]
            if flow is not None and tuple(flow.shape[1:3]) != (hs, ws):
                flow = resize(flow.permute(0, 3, 1, 2), hs, ws).permute(0, 2, 3, 1)
                certainty = resize(certainty, hs, ws)
            if ins == 16:
                gp_post = self.gps[s](fa_s, fb_s)
                cls_logits, certainty = self.embedding_decoder(torch.cat([gp_post, fa_s], dim=1))
                flow = cls_to_flow_refine(cls_logits)
                corresps[ins] = {"gm_cls": cls_logits, "gm_certainty": certainty}
            delta_flow, delta_cert = self.conv_refiner[s](fa_s, fb_s, flow, scale_factor=scale_factor)
            # the delta is in pixels of the current map: normalise by its size
            flow = flow + delta_flow / torch.tensor([ws, hs], dtype=torch.float32, device=flow.device)
            certainty = certainty + delta_cert
            corresps.setdefault(ins, {}).update({"flow": flow, "certainty": certainty})
            if s != scales[-1] and self.detach_between_scales:
                flow, certainty = flow.detach(), certainty.detach()
        return corresps


def symmetric_forward(encoder: Encoder, decoder: RoMaDecoder, im_a, im_b, flow=None, certainty=None,
                      upsample: bool = False, scale_factor: float = 1.0) -> dict:
    """The network's symmetric protocol: a coarse pass, or with `upsample`
    a refiner-only pass (scales 8 -> 1) from a given flow. im_a, im_b
    (B, 3, H, W) -> corresps over the doubled batch: the first half A -> B,
    the second B -> A. Both images go through the encoders as one batch."""
    B = im_a.shape[0]
    feats = encoder(torch.cat([im_a, im_b]), coarse=not upsample)
    f_s = {s: torch.cat([f[B:], f[:B]]) for s, f in feats.items()}
    return decoder(feats, f_s, flow=flow, certainty=certainty, upsample=upsample, scale_factor=scale_factor)
