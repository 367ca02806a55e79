"""DINOv2 ViT patch-feature backbone (counterpart of
`gluefactory_tpu/models/backbones/dinov2.py`): the last block's output
after the final LayerNorm, split into the cls token and the (B, ph, pw, D)
patch-feature grid, as the official `get_intermediate_layers(n=1,
return_class_token=True, reshape=True)` returns it.

  - a 14 x 14 / 14 patch-embedding conv, then the cls token and the
    optional register tokens prepended, learned position embeddings added
    (the pretraining grid of 518 / 14 = 37 x 37 resized bicubically for
    another grid: torch's `interpolate(mode="bicubic", align_corners=False)`,
    no antialias; the cls position unchanged);
  - pre-norm blocks with a fused qkv (output channels [q; k; v], each
    head-major), LayerScale on both residual branches and an exact (erf)
    GELU MLP; a final LayerNorm; eps 1e-6 throughout.

Parameters carry the official torch-hub names (`patch_embed.proj`,
`cls_token`, `pos_embed`, `register_tokens`, `blocks.{i}.{norm1, attn.qkv,
attn.proj, ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma}`, `norm`), so the
official checkpoint loads and the JAX package's `convert_dinov2` reads the
state dict as it is. No ImageNet normalisation is applied here: the caller
feeds the image it wants embedded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base_model import BaseModel

VIT_CONFS = {
    "dinov2_vits14": {"embed_dim": 384, "depth": 12, "num_heads": 6},
    "dinov2_vitb14": {"embed_dim": 768, "depth": 12, "num_heads": 12},
    "dinov2_vitl14": {"embed_dim": 1024, "depth": 24, "num_heads": 16},
    # the giant variant's SwiGLU FFN is another block function: not offered
}


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, D // self.num_heads).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(q, k, v)
        return self.proj(y.transpose(1, 2).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    """Pre-norm block with LayerScale, the official DINOv2 layout."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoV2(BaseModel):
    default_conf = {
        "weights": "dinov2_vits14",
        "patch_size": 14,
        "img_size": 518,  # pretraining grid; pos_embed resizes for others
        "num_register_tokens": 0,  # 4 for the *_reg variants
        "allow_resize": False,  # round H and W down to multiples of the patch
        "trainable": False,
        # override VIT_CONFS (narrow widths in tests); None = per `weights`
        "embed_dim": None,
        "depth": None,
        "num_heads": None,
    }
    required_data_keys = ["image"]

    def _init(self, conf):
        cfg = dict(VIT_CONFS[conf.weights])
        for k in ("embed_dim", "depth", "num_heads"):
            if conf[k] is not None:
                cfg[k] = conf[k]
        D = self.embed_dim = cfg["embed_dim"]
        p = conf.patch_size
        self.grid0 = conf.img_size // p  # the pretraining patch grid (37)
        self.patch_embed = PatchEmbed(p, D)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, D))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, 1 + self.grid0 * self.grid0, D))
        if conf.num_register_tokens:
            self.register_tokens = nn.Parameter(0.02 * torch.randn(1, conf.num_register_tokens, D))
        self.blocks = nn.ModuleList(Block(D, cfg["num_heads"]) for _ in range(cfg["depth"]))
        self.norm = nn.LayerNorm(D, eps=1e-6)

    def _interp_pos_embed(self, ph: int, pw: int) -> tuple:
        """The official `interpolate_pos_encoding`: the patch grid resized
        bicubically (a = -0.75, align_corners False, no antialias); the cls
        position unchanged."""
        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if ph == self.grid0 and pw == self.grid0:
            return cls_pos, patch_pos
        g = self.grid0
        grid = patch_pos.reshape(1, g, g, self.embed_dim).permute(0, 3, 1, 2).float()
        grid = F.interpolate(grid, size=(ph, pw), mode="bicubic", align_corners=False)
        return cls_pos, grid.permute(0, 2, 3, 1).reshape(1, ph * pw, self.embed_dim)

    def _forward(self, data: dict, train: bool = False) -> dict:
        image = data["image"]  # (B, H, W, C)
        B, H, W, C = image.shape
        if C == 1:
            image = image.expand(B, H, W, 3)
        p = self.conf.patch_size
        ph, pw = H // p, W // p
        if self.conf.allow_resize and (H % p or W % p):
            # legacy nearest (`F.upsample` to the multiples): src = floor(dst * in / out)
            dev = image.device
            iy = torch.floor(torch.arange(ph * p, dtype=torch.float32, device=dev) * (H / (ph * p))).long()
            ix = torch.floor(torch.arange(pw * p, dtype=torch.float32, device=dev) * (W / (pw * p))).long()
            image = image[:, iy][:, :, ix]
        x = self.patch_embed.proj(image[:, :ph * p, :pw * p].permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, ph * pw, D)
        cls_pos, patch_pos = self._interp_pos_embed(ph, pw)
        x = x + patch_pos.to(x.dtype)
        toks = [(self.cls_token + cls_pos).expand(B, -1, -1)]
        if self.conf.num_register_tokens:
            toks.append(self.register_tokens.expand(B, -1, -1))
        x = torch.cat(toks + [x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        n_prefix = 1 + self.conf.num_register_tokens
        return {
            "features": x[:, n_prefix:].reshape(B, ph, pw, self.embed_dim),
            "global_descriptor": x[:, 0],
            "descriptors": x[:, n_prefix:],
        }

    def loss(self, pred, data, train: bool = False):
        raise NotImplementedError
