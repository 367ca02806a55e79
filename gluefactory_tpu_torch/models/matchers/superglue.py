"""SuperGlue: attentional GNN matcher with log-domain Sinkhorn optimal
transport, inference and training (counterpart of
`gluefactory_tpu/models/matchers/superglue.py`).

Parameters carry the names and shapes of the official MagicLeap release
(`superglue_{indoor,outdoor}.pth`): `kenc.encoder.{0,3,6,9,12}` (Conv1d)
with BatchNorm1d at 1, 4, 7, 10; `gnn.layers.{i}.attn.proj.{0,1,2}`,
`gnn.layers.{i}.attn.merge`, `gnn.layers.{i}.mlp.{0,1,3}`; `final_proj`;
`bin_score`. Conv1d weights are (O, I, 1), so official checkpoints load as
they are. The forward runs on (B, N, C) tokens with each 1x1 Conv1d as a
linear map.

BatchNorm follows flax's, as the JAX model uses it, and the `train`
argument picks the mode (`torch.nn.Module.training` decides nothing):
`train=False` normalises by the running statistics; `train=True` by the
batch's mean and biased variance over every B x N token, padded slots
included (the JAX model does not mask them), and then sets each running
statistic to 0.9 old + 0.1 batch, the biased variance included (PyTorch's
own training mode would store the unbiased one). Each BatchNorm is updated
once per call in the JAX model's order: the keypoint encoder on view 0,
then view 1; each GNN layer on its view-0 update, then its view-1 one.
With `checkpointed` (and grad enabled), each GNN layer call runs under
`torch.utils.checkpoint`; its statistics are applied when the forward
returns, so the recompute in the backward does not update them again.

Head layout: the official attention packs channels head-fastest,
c = dh * H + h, but the attention kernel wants each head's features
contiguous. `MultiHeadedAttention` permutes its weights once, when a state
dict is loaded (rows of `proj.*`, columns of `merge`), and permutes them back
when one is saved: inside the module the heads are head-major
(c = h * Dh + dh), so q, k, v split into heads as views and no copy is made.

Each layer calls `mha` once per view in self layers and once per direction in
cross layers, as the JAX model does: 36 attention launches per forward at 9
layer pairs (and 36 more in a checkpointed backward's recompute), and one
Sinkhorn launch.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.assignment import filter_matches, log_optimal_transport
from ...ops.attention import mha
from ...utils.distributed import batch_mean
from ..base_model import BaseModel
from ..losses import nll_components
from ..metrics import matcher_metrics
from .lightglue import merge_heads, split_heads

# flax's BatchNorm momentum: running = MOMENTUM * running + (1 - MOMENTUM) * batch
MOMENTUM = 0.9


def normalize_keypoints_sg(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Center by size / 2, scale by 0.7 * max(size); size (B, 2) [w, h]."""
    size = size.to(kpts.dtype)
    center = size / 2.0
    scaling = size.max(dim=-1, keepdim=True).values * 0.7
    return (kpts - center[:, None, :]) / scaling[:, None, :]


def _pointwise(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv1d on (B, N, C) tokens."""
    return F.linear(x, layer.weight[..., 0], layer.bias)


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, stats: list | None = None) -> torch.Tensor:
    """BatchNorm on (B, N, C). `stats` None: by the running statistics (one
    kernel). A list: by the batch's mean and biased variance over every
    token, in float32 as flax computes them (E[x^2] - E[x]^2, at least 0),
    and the (mean, variance) pair appended to `stats` for
    `update_running_stats`; the running statistics are not read."""
    if stats is None:
        y = F.batch_norm(x.reshape(-1, x.shape[-1]), bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, training=False, eps=bn.eps)
        return y.reshape(x.shape)
    flat = x.reshape(-1, x.shape[-1]).float()
    mean = batch_mean(flat.mean(0))  # the global batch's under data parallelism
    var = (batch_mean((flat * flat).mean(0)) - mean * mean).clamp(min=0.0)
    y = (flat - mean) * (torch.rsqrt(var + bn.eps) * bn.weight.float()) + bn.bias.float()
    stats.append((mean.detach(), var.detach()))
    return y.to(x.dtype).reshape(x.shape)


def update_running_stats(bns: list, stats: list) -> None:
    """Each BatchNorm's running mean and variance to MOMENTUM old + (1 -
    MOMENTUM) batch, from the (mean, biased variance) pairs `_batch_norm`
    appended, in order."""
    with torch.no_grad():
        for bn, (mean, var) in zip(bns, stats):
            bn.running_mean.copy_(MOMENTUM * bn.running_mean + (1.0 - MOMENTUM) * mean)
            bn.running_var.copy_(MOMENTUM * bn.running_var + (1.0 - MOMENTUM) * var)


def make_mlp(channels: list) -> nn.Sequential:
    """Official MLP: Conv1d(1x1), then BatchNorm1d and ReLU after all but the
    last conv."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], kernel_size=1, bias=True))
        if i < len(channels) - 1:
            layers.append(nn.BatchNorm1d(channels[i], eps=1e-5))
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def run_mlp(mlp: nn.Sequential, x: torch.Tensor, stats: list | None = None) -> torch.Tensor:
    """The MLP on (B, N, C); BatchNorm by the batch with a `stats` list
    (`_batch_norm`), else by the running statistics."""
    for layer in mlp:
        if isinstance(layer, nn.Conv1d):
            x = _pointwise(layer, x)
        elif isinstance(layer, nn.BatchNorm1d):
            x = _batch_norm(layer, x, stats)
        else:
            x = torch.relu(x)
    return x


def batch_norms(mlp: nn.Sequential) -> list:
    return [m for m in mlp if isinstance(m, nn.BatchNorm1d)]


def head_major_permutation(dim: int, num_heads: int) -> torch.Tensor:
    """perm with head_major[i] = official[perm[i]]: official channel
    dh * H + h sits at h * Dh + dh."""
    Dh = dim // num_heads
    h, dh = torch.meshgrid(torch.arange(num_heads), torch.arange(Dh), indexing="ij")
    return (dh * num_heads + h).reshape(-1)


class MultiHeadedAttention(nn.Module):
    """Official parameters (`proj.{0,1,2}`, `merge`), stored head-major."""

    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.merge = nn.Conv1d(d_model, d_model, kernel_size=1)
        self.proj = nn.ModuleList([copy.deepcopy(self.merge) for _ in range(3)])
        self._register_load_state_dict_pre_hook(_official_to_head_major, with_module=True)
        self._register_state_dict_hook(_head_major_to_official)


def _permute_heads(module: MultiHeadedAttention, sd: dict, prefix: str, inverse: bool) -> None:
    """Permute the rows of `proj.*` and the columns of `merge` in `sd`."""
    perm = head_major_permutation(module.merge.in_channels, module.num_heads)
    if inverse:
        perm = torch.argsort(perm)
    for j in range(3):
        for name in ("weight", "bias"):
            key = f"{prefix}proj.{j}.{name}"
            if key in sd:
                sd[key] = sd[key][perm.to(sd[key].device)]
    key = f"{prefix}merge.weight"
    if key in sd:
        sd[key] = sd[key][:, perm.to(sd[key].device)]


def _official_to_head_major(module, state_dict, prefix, *args):
    _permute_heads(module, state_dict, prefix, inverse=False)


def _head_major_to_official(module, state_dict, prefix, local_metadata):
    _permute_heads(module, state_dict, prefix, inverse=True)
    return state_dict


class AttentionalPropagation(nn.Module):
    def __init__(self, feature_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.flash = True
        self.attn = MultiHeadedAttention(num_heads, feature_dim)
        self.mlp = make_mlp([2 * feature_dim, 2 * feature_dim, feature_dim])
        nn.init.constant_(self.mlp[-1].bias, 0.0)

    def forward(self, x, source, mask_q=None, mask_k=None, stats: list | None = None):
        q, k, v = (split_heads(_pointwise(p, t), self.num_heads)
                   for p, t in zip(self.attn.proj, (x, source, source)))
        ctx = mha(q, k, v, mask_q=mask_q, mask_k=mask_k, flash=self.flash)
        message = _pointwise(self.attn.merge, merge_heads(ctx))
        return x + run_mlp(self.mlp, torch.cat([x, message], dim=-1), stats)


def propagate(layer: AttentionalPropagation, x, source, mask_q, mask_k, train: bool,
              checkpointed: bool) -> torch.Tensor:
    """One attention layer call; with `checkpointed` (and grad enabled)
    under `torch.utils.checkpoint`, its activations recomputed in the
    backward. With `train`, its BatchNorm by the batch and its running
    statistics updated after the call, outside the checkpoint, so that the
    recompute leaves them alone."""
    stats = [] if train else None
    if checkpointed and torch.is_grad_enabled():
        out = checkpoint(layer, x, source, mask_q, mask_k, stats, use_reentrant=False)
    else:
        out = layer(x, source, mask_q, mask_k, stats)
    if train:
        update_running_stats(batch_norms(layer.mlp), stats)
    return out


class KeypointEncoder(nn.Module):
    def __init__(self, feature_dim: int, layers: list):
        super().__init__()
        self.encoder = make_mlp([3, *layers, feature_dim])
        nn.init.constant_(self.encoder[-1].bias, 0.0)


class AttentionalGNN(nn.Module):
    def __init__(self, feature_dim: int, num_heads: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [AttentionalPropagation(feature_dim, num_heads) for _ in range(2 * n_layers)]
        )


class SuperGlue(BaseModel):
    default_conf = {
        "descriptor_dim": 256,
        "keypoint_encoder": [32, 64, 128, 256],
        "n_layers": 9,  # pairs of (self, cross)
        "num_heads": 4,
        "sinkhorn_iterations": 50,
        "filter_threshold": 0.2,
        "checkpointed": True,
        "weights": None,
        "loss": {"nll_balancing": 0.5},
    }
    required_data_keys = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1",
        "keypoint_scores0", "keypoint_scores1",
    ]

    def _init(self, conf):
        d = conf.descriptor_dim
        # the CUDA attention and Sinkhorn kernels; False runs the plain
        # versions on any device (to compare them with the kernels)
        self.flash = True
        self.kenc = KeypointEncoder(d, list(conf.keypoint_encoder))
        self.gnn = AttentionalGNN(d, conf.num_heads, conf.n_layers)
        self.final_proj = nn.Conv1d(d, d, kernel_size=1, bias=True)
        self.bin_score = nn.Parameter(torch.tensor(1.0))

    def _layer(self, layer, x, source, mask_q, mask_k, train: bool):
        return propagate(layer, x, source, mask_q, mask_k, train, self.conf.checkpointed)

    def _forward(self, data: dict, train: bool = False) -> dict:
        """`train`: BatchNorm by the batch, the running statistics updated."""
        c = self.conf
        desc0, desc1 = data["descriptors0"], data["descriptors1"]
        mask0 = data.get("keypoint_mask0")
        mask1 = data.get("keypoint_mask1")
        size0 = data["view0"]["image_size"] if "view0" in data else data["image_size0"]
        size1 = data["view1"]["image_size"] if "view1" in data else data["image_size1"]

        # the encoder input follows the descriptors' dtype: keypoints and
        # scores may arrive in f32 and would otherwise lift a bf16 GNN to f32
        def encode(kpts, size, scores, desc):
            p = normalize_keypoints_sg(kpts, size)
            enc_in = torch.cat([p, scores[..., None].to(p.dtype)], dim=-1).to(desc.dtype)
            stats = [] if train else None
            out = desc + run_mlp(self.kenc.encoder, enc_in, stats)
            if train:
                update_running_stats(batch_norms(self.kenc.encoder), stats)
            return out

        x0 = encode(data["keypoints0"], size0, data["keypoint_scores0"], desc0)
        x1 = encode(data["keypoints1"], size1, data["keypoint_scores1"], desc1)
        for i, layer in enumerate(self.gnn.layers):
            if i % 2 == 0:  # self-attention
                x0 = self._layer(layer, x0, x0, mask0, mask0, train)
                x1 = self._layer(layer, x1, x1, mask1, mask1, train)
            else:  # cross-attention
                x0, x1 = (self._layer(layer, x0, x1, mask0, mask1, train),
                          self._layer(layer, x1, x0, mask1, mask0, train))

        mdesc0 = _pointwise(self.final_proj, x0)
        mdesc1 = _pointwise(self.final_proj, x1)
        # similarity and transport in f32 (products of bf16 values are exact)
        sim = torch.einsum("bmd,bnd->bmn", mdesc0.float(), mdesc1.float()) / c.descriptor_dim**0.5
        scores = log_optimal_transport(sim, self.bin_score, c.sinkhorn_iterations, mask0, mask1,
                                       flash=self.flash)
        m0, m1, ms0, ms1 = filter_matches(scores, c.filter_threshold, mask0, mask1)
        return {
            "log_assignment": scores,
            "matches0": m0,
            "matches1": m1,
            "matching_scores0": ms0,
            "matching_scores1": ms1,
        }

    def loss(self, pred: dict, data: dict, train: bool = False):
        """NLL on the transport plan, the negative counts clamped as a sum
        (SuperGlue's convention), balanced by `loss.nll_balancing`, with the
        diagnostics `nll_pos`, `nll_neg`, `num_matchable`, `num_unmatchable`
        and `bin_score`; `matcher_metrics` only at eval."""
        scores = pred["log_assignment"]
        nll_pos, nll_neg, num_pos, num_neg = nll_components(
            scores, data["gt_assignment"], data["gt_matches0"], data["gt_matches1"],
            per_side_clamp=False)
        b = self.conf.loss.nll_balancing
        nll = b * nll_pos + (1.0 - b) * nll_neg
        losses = {
            "total": nll,
            "assignment_nll": nll,
            "nll_pos": nll_pos,
            "nll_neg": nll_neg,
            "num_matchable": num_pos,
            "num_unmatchable": num_neg,
            "bin_score": self.bin_score.detach().expand(scores.shape[0]),
        }
        if train:
            return losses, {}
        return losses, matcher_metrics(pred, data)
