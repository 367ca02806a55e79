"""LightGlue: attentional sparse-feature matcher, inference forward
(counterpart of `gluefactory_tpu/models/matchers/lightglue.py`).

Parameters carry the names and layout of the official LightGlue release
(`transformers.{i}.self_attn.Wqkv`, `...cross_attn.to_qk`, `log_assignment.{i}`,
`token_confidence.{i}.token.0`, ...; Wqkv packs rows as (head, dim, q/k/v)),
so official checkpoints load without a second converter. `input_proj` is
always a Linear, as in the JAX package; the official model has none when
input_dim == descriptor_dim (an identity there), so a state dict without
`input_proj.*` loads it as the identity and zero bias, as the JAX
converter (`gluefactory_tpu/compat/torch_conversion.py::convert_lightglue`)
fills it in. `compat/jax_params.py` converts the JAX package's parameters
to this layout.

As in the JAX package, both views go through self-attention as one stacked
batch, the cross-attention projections run once over the stacked views, and
attention is the hand-written CUDA kernels on the card (`ops/attention.py`).

Adaptive depth and width pruning (`depth_confidence`, `width_confidence`)
is the JAX package's masked static-shape realization, `_pruned_forward`:
width pruning clears the active mask of confidently unmatchable tokens,
depth pruning freezes an item's descriptors once enough of its tokens are
confident and takes its assignment from that layer. It runs every layer
and an assignment head at each, so it prunes the assignment, not the time;
`lightglue_serving.make_serving_fn` runs the same rules and stops at the
exit. Below `pruning_min_kpts` keypoints the dense forward runs instead.

Training (`train=True`): no pruning, every layer's descriptors stacked as
`ref_descriptors0/1` (B, L, M, D) for the deep supervision of `loss`, and with
`checkpointed` each TransformerLayer under `torch.utils.checkpoint`
(non-reentrant) while autograd records: its activations are recomputed in
the backward, the attention kernels included.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.assignment import filter_matches, sigmoid_log_double_softmax
from ...ops.attention import apply_rotary, bidirectional_attention, mha
from ..base_model import BaseModel
from ..losses import masked_row_norm, nll_components
from ..metrics import matcher_metrics


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Center and scale keypoints by image size (B, 2) [w, h]."""
    size = size.to(kpts.dtype)
    shift = size / 2.0
    scale = size.max(dim=-1, keepdim=True).values / 2.0
    return (kpts - shift[:, None, :]) / scale[:, None, :]


class LearnableFourierPosEnc(nn.Module):
    """Keypoints (B, N, 2) -> per-pair rotary angles' (cos, sin), (B, N, head_dim/2)."""

    def __init__(self, in_dim: int, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(in_dim, head_dim // 2, bias=False)

    def forward(self, x: torch.Tensor):
        # in the keypoints' f32 whatever the weights' dtype (as flax promotes)
        theta = F.linear(x, self.Wr.weight.to(x.dtype))
        return torch.cos(theta), torch.sin(theta)


def _ffn(dim: int) -> nn.Sequential:
    """Linear(2d->2d), LayerNorm(eps 1e-5), exact GELU, Linear(2d->d)."""
    return nn.Sequential(
        nn.Linear(2 * dim, 2 * dim), nn.LayerNorm(2 * dim, eps=1e-5), nn.GELU(), nn.Linear(2 * dim, dim)
    )


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, Dh = x.shape
    return x.transpose(1, 2).reshape(B, N, H * Dh)


class SelfBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, flash: bool):
        super().__init__()
        self.num_heads = num_heads
        self.flash = flash
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

    def forward(self, x, enc, mask=None):
        cos, sin = enc
        B, N, _ = x.shape
        # official packing: rows as (head, dim, q/k/v)
        qkv = self.Wqkv(x).reshape(B, N, self.num_heads, -1, 3).transpose(1, 2)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        q = apply_rotary(q, cos[:, None], sin[:, None])
        k = apply_rotary(k, cos[:, None], sin[:, None])
        ctx = mha(q, k, v.contiguous(), mask_q=mask, mask_k=mask, flash=self.flash)
        message = self.out_proj(merge_heads(ctx))
        return x + self.ffn(torch.cat([x, message], dim=-1))


class CrossBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, flash: bool):
        super().__init__()
        self.num_heads = num_heads
        self.flash = flash
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = _ffn(dim)

    def forward(self, x0, x1, mask0=None, mask1=None):
        B = x0.shape[0]
        stacked = x0.shape == x1.shape
        if stacked:  # one shared-weight projection pass over both views
            x01 = torch.cat([x0, x1], dim=0)
            qk01 = split_heads(self.to_qk(x01), self.num_heads)
            v01 = split_heads(self.to_v(x01), self.num_heads)
            qk0, qk1, v0, v1 = qk01[:B], qk01[B:], v01[:B], v01[B:]
        else:
            qk0 = split_heads(self.to_qk(x0), self.num_heads)
            qk1 = split_heads(self.to_qk(x1), self.num_heads)
            v0 = split_heads(self.to_v(x0), self.num_heads)
            v1 = split_heads(self.to_v(x1), self.num_heads)
        m0, m1 = bidirectional_attention(qk0, qk1, v0, v1, mask0, mask1, flash=self.flash)
        if stacked:
            x01 = torch.cat([x0, x1], dim=0)
            m01 = self.to_out(merge_heads(torch.cat([m0, m1], dim=0)))
            y01 = x01 + self.ffn(torch.cat([x01, m01], dim=-1))
            return y01[:B], y01[B:]
        m0 = self.to_out(merge_heads(m0))
        m1 = self.to_out(merge_heads(m1))
        return x0 + self.ffn(torch.cat([x0, m0], -1)), x1 + self.ffn(torch.cat([x1, m1], -1))


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, flash: bool):
        super().__init__()
        self.self_attn = SelfBlock(dim, num_heads, flash)
        self.cross_attn = CrossBlock(dim, num_heads, flash)

    def forward(self, desc0, desc1, enc0, enc1, mask0=None, mask1=None):
        if desc0.shape == desc1.shape:
            # both views through one batched self-attention pass
            B = desc0.shape[0]
            x = torch.cat([desc0, desc1], dim=0)
            enc = tuple(torch.cat([e0, e1], dim=0) for e0, e1 in zip(enc0, enc1))
            if mask0 is None and mask1 is None:
                mask = None
            else:
                ones = torch.ones(desc0.shape[:2], dtype=torch.bool, device=desc0.device)
                mask = torch.cat([ones if mask0 is None else mask0,
                                  ones if mask1 is None else mask1], dim=0)
            x = self.self_attn(x, enc, mask)
            desc0, desc1 = x[:B], x[B:]
        else:
            desc0 = self.self_attn(desc0, enc0, mask0)
            desc1 = self.self_attn(desc1, enc1, mask1)
        return self.cross_attn(desc0, desc1, mask0, mask1)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.matchability = nn.Linear(dim, 1)
        self.final_proj = nn.Linear(dim, dim)

    def forward(self, desc0, desc1, mask0=None, mask1=None):
        scale = 1.0 / self.dim**0.25
        mdesc0 = self.final_proj(desc0) * scale
        mdesc1 = self.final_proj(desc1) * scale
        # similarity in f32 (the products of bf16 values are exact in f32)
        sim = torch.einsum("bmd,bnd->bmn", mdesc0.float(), mdesc1.float())
        z0 = self.matchability(desc0).squeeze(-1).float()
        z1 = self.matchability(desc1).squeeze(-1).float()
        scores = sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1)
        return scores, sim, z0, z1

    def get_matchability(self, desc: torch.Tensor) -> torch.Tensor:
        """The matchability logit alone, in f32 (the width-pruning rule
        needs it at every layer without the M x N similarity)."""
        return self.matchability(desc).squeeze(-1).float()


class TokenConfidence(nn.Module):
    """Per-token confidence that a token's match will not change in later
    layers: a Linear to one logit, in f32, then the sigmoid."""

    def __init__(self, dim: int):
        super().__init__()
        self.token = nn.Sequential(nn.Linear(dim, 1), nn.Sigmoid())

    def forward(self, desc0, desc1, return_logits: bool = False):
        linear = self.token[0]
        l0 = linear(desc0).squeeze(-1).float()
        l1 = linear(desc1).squeeze(-1).float()
        if return_logits:
            return l0, l1
        return torch.sigmoid(l0), torch.sigmoid(l1)


# Below this many keypoints (the larger view) adaptive pruning costs more
# time than it saves, so the dense forward runs: the JAX package's table
# (`lightglue.py:247`, keyed there by backend) keyed by torch device type.
PRUNING_KEYPOINT_THRESHOLDS = {"cpu": -1, "cuda": 1024}


def _identity_input_proj(module, state_dict, prefix, *args) -> None:
    """Load pre-hook: an official state dict without `input_proj.*` (its
    nn.Identity when input_dim == descriptor_dim) gets the identity weight
    and a zero bias."""
    keys = (prefix + "input_proj.weight", prefix + "input_proj.bias")
    if any(k in state_dict for k in keys) or module.conf.input_dim != module.conf.descriptor_dim:
        return
    w = module.input_proj.weight
    state_dict[keys[0]] = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    state_dict[keys[1]] = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)


class LightGlue(BaseModel):
    default_conf = {
        "input_dim": 256,
        "descriptor_dim": 256,
        "add_scale_ori": False,
        "n_layers": 9,
        "num_heads": 4,
        "flash": True,  # the CUDA attention kernels on the card
        "depth_confidence": -1.0,
        "width_confidence": -1.0,
        "pruning_min_kpts": "auto",
        "int8_similarity": False,
        "filter_threshold": 0.1,
        "checkpointed": True,
        "weights": None,
        "loss": {"gamma": 1.0, "fn": "nll", "nll_balancing": 0.5, "confidence_weight": 1.0},
    }
    required_data_keys = ["keypoints0", "keypoints1", "descriptors0", "descriptors1"]

    def _init(self, conf):
        if conf.int8_similarity:
            raise NotImplementedError("int8_similarity is not ported yet")
        d = conf.descriptor_dim
        self.input_proj = nn.Linear(conf.input_dim, d)
        self.posenc = LearnableFourierPosEnc(2 + 2 * bool(conf.add_scale_ori), d // conf.num_heads)
        self.transformers = nn.ModuleList(
            [TransformerLayer(d, conf.num_heads, bool(conf.flash)) for _ in range(conf.n_layers)]
        )
        self.log_assignment = nn.ModuleList([MatchAssignment(d) for _ in range(conf.n_layers)])
        self.token_confidence = nn.ModuleList([TokenConfidence(d) for _ in range(conf.n_layers - 1)])
        self.register_load_state_dict_pre_hook(_identity_input_proj)

    def _encode(self, data: dict):
        """(desc0, desc1, enc0, enc1, mask0, mask1): projected descriptors,
        rotary encodings of the normalized keypoints (with `add_scale_ori`,
        each keypoint's scale and orientation beside them), keypoint masks."""
        encs = []
        for i in "01":
            size = data[f"view{i}"]["image_size"] if f"view{i}" in data else data[f"image_size{i}"]
            p = normalize_keypoints(data[f"keypoints{i}"], size)
            if self.conf.add_scale_ori:
                p = torch.cat([p, data[f"scales{i}"][..., None].to(p.dtype),
                               data[f"oris{i}"][..., None].to(p.dtype)], dim=-1)
            encs.append(self.posenc(p))
        enc0, enc1 = encs
        desc0 = self.input_proj(data["descriptors0"])
        desc1 = self.input_proj(data["descriptors1"])
        return desc0, desc1, enc0, enc1, data.get("keypoint_mask0"), data.get("keypoint_mask1")

    def _forward(self, data: dict, train: bool = False) -> dict:
        c = self.conf
        desc0, desc1, enc0, enc1, mask0, mask1 = self._encode(data)
        kpts0, kpts1 = data["keypoints0"], data["keypoints1"]
        do_prune = not train and (c.depth_confidence > 0 or c.width_confidence > 0) and (
            max(kpts0.shape[1], kpts1.shape[1]) >= self.pruning_min_kpts(kpts0.device))
        all_desc0, all_desc1 = [], []
        if do_prune:
            scores, prune0, prune1 = self._pruned_forward(desc0, desc1, enc0, enc1, mask0, mask1)
        else:
            recompute = c.checkpointed and torch.is_grad_enabled()
            for layer in self.transformers:
                if recompute:
                    desc0, desc1 = checkpoint(layer, desc0, desc1, enc0, enc1, mask0, mask1,
                                              use_reentrant=False)
                else:
                    desc0, desc1 = layer(desc0, desc1, enc0, enc1, mask0, mask1)
                if train:
                    all_desc0.append(desc0)
                    all_desc1.append(desc1)
            scores, _, _, _ = self.log_assignment[-1](desc0, desc1, mask0, mask1)
        pred = self.match_outputs(scores, mask0, mask1)
        if train:
            pred["ref_descriptors0"] = torch.stack(all_desc0, dim=1)  # (B, L, M, D)
            pred["ref_descriptors1"] = torch.stack(all_desc1, dim=1)
        if do_prune:
            pred["prune0"] = prune0
            pred["prune1"] = prune1
        return pred

    def match_outputs(self, scores, mask0, mask1) -> dict:
        m0, m1, mscores0, mscores1 = filter_matches(scores, self.conf.filter_threshold, mask0, mask1)
        return {
            "log_assignment": scores,
            "matches0": m0,
            "matches1": m1,
            "matching_scores0": mscores0,
            "matching_scores1": mscores1,
        }

    def pruning_min_kpts(self, device: torch.device) -> int:
        """The pruning guard's keypoint count on `device`: conf "auto" looks
        up the device type in PRUNING_KEYPOINT_THRESHOLDS, an int overrides
        it, -1 never guards."""
        v = self.conf.pruning_min_kpts
        if v == "auto":
            return PRUNING_KEYPOINT_THRESHOLDS.get(torch.device(device).type, -1)
        return int(v)

    def _confidence_threshold(self, layer_index: int) -> float:
        """Token-confidence threshold of a layer (reference `lightglue.py:540-544`)."""
        return min(0.8 + 0.1 * math.exp(-4.0 * layer_index / self.conf.n_layers), 1.0)

    def _pruned_forward(self, desc0, desc1, enc0, enc1, mask0, mask1):
        """Adaptive depth and width pruning, masked: every layer runs on
        every item, with the active masks as attention masks.

        - width: a token whose matchability is below 1 - width_confidence,
          and that is confident (when depth pruning is on), leaves the
          active mask; its descriptor still takes the FFN of a zero message;
        - depth: once more than depth_confidence of an item's active tokens
          are confident, its descriptors freeze and its assignment is that
          layer's;
        - prune0/1 count 1 + the width rounds a token stayed active through
          while its item ran (n_layers everywhere when width pruning is off).
        """
        c = self.conf
        B, M, _ = desc0.shape
        N = desc1.shape[1]
        dev = desc0.device
        active0 = mask0 if mask0 is not None else torch.ones(B, M, dtype=torch.bool, device=dev)
        active1 = mask1 if mask1 is not None else torch.ones(B, N, dtype=torch.bool, device=dev)
        prune0 = torch.ones(B, M, dtype=torch.int32, device=dev)
        prune1 = torch.ones(B, N, dtype=torch.int32, device=dev)
        stopped = torch.zeros(B, dtype=torch.bool, device=dev)
        final_scores = None
        for i in range(c.n_layers):
            nd0, nd1 = self.transformers[i](desc0, desc1, enc0, enc1, active0, active1)
            desc0 = torch.where(stopped[:, None, None], desc0, nd0)
            desc1 = torch.where(stopped[:, None, None], desc1, nd1)
            scores_i, _, z0, z1 = self.log_assignment[i](desc0, desc1, active0, active1)
            if final_scores is None:
                final_scores = torch.full_like(scores_i, -math.inf)
            if i == c.n_layers - 1:
                final_scores = torch.where(stopped[:, None, None], final_scores, scores_i)
                break
            conf_th = self._confidence_threshold(i)
            # token confidences only for the depth rule: with depth pruning
            # off, the width keep-rule drops its low-confidence clause
            c0 = c1 = None
            if c.depth_confidence > 0:
                c0, c1 = self.token_confidence[i](desc0, desc1)
                stop_now = _exits(c0, c1, active0, active1, conf_th, c.depth_confidence) & ~stopped
            else:
                stop_now = torch.zeros_like(stopped)
            final_scores = torch.where(stop_now[:, None, None], scores_i, final_scores)
            stopped = stopped | stop_now
            if c.width_confidence > 0:
                active0, p0 = _width_round(active0, z0, c0, conf_th, c.width_confidence, stopped)
                active1, p1 = _width_round(active1, z1, c1, conf_th, c.width_confidence, stopped)
                prune0, prune1 = prune0 + p0, prune1 + p1
        if not c.width_confidence > 0:
            prune0 = torch.full((B, M), c.n_layers, dtype=torch.int32, device=dev)
            prune1 = torch.full((B, N), c.n_layers, dtype=torch.int32, device=dev)
        return final_scores, prune0, prune1


    # ------------------------------------------------------------------
    # loss: deep supervision
    # ------------------------------------------------------------------

    def _nll(self, log_assignment, data):
        """Balanced NLL of a (B, M+1, N+1) log assignment against GT, and its
        components (LightGlue's per-side clamp)."""
        nll_pos, nll_neg, num_pos, num_neg = nll_components(
            log_assignment, data["gt_assignment"], data["gt_matches0"], data["gt_matches1"],
            per_side_clamp=True)
        b = self.conf.loss.nll_balancing
        return b * nll_pos + (1.0 - b) * nll_neg, nll_pos, nll_neg, num_pos, num_neg

    def loss(self, pred: dict, data: dict, train: bool = False):
        """The JAX package's loss.

        train=True: deep supervision over every layer, the NLL of layer i
        weighted `gamma ** (L-i-1)` when gamma > 0 (the default 1.0 weighs
        every layer 1), `i + 1` otherwise, normalised by the weights' sum,
        plus `confidence_weight` times the token-confidence BCE (in f32, on
        detached descriptors: does layer i's match equal the final one);
        no metrics.

        train=False: the final layer's NLL alone and `matcher_metrics`.
        """
        c = self.conf
        mask0 = data.get("keypoint_mask0")
        mask1 = data.get("keypoint_mask1")
        nll_final, nll_pos, nll_neg, num_pos, num_neg = self._nll(pred["log_assignment"], data)
        losses = {
            "total": nll_final,
            "last": nll_final.detach(),
            "assignment_nll": nll_final,
            "nll_pos": nll_pos,
            "nll_neg": nll_neg,
            "num_matchable": num_pos,
            "num_unmatchable": num_neg,
            "row_norm": masked_row_norm(pred["log_assignment"], mask0),
        }
        if not train:
            return losses, matcher_metrics(pred, data)

        L = pred["ref_descriptors0"].shape[1]
        final_scores = pred["log_assignment"]
        # full-row / -column argmax, the dustbin included
        final_m0 = final_scores[:, :-1, :].argmax(-1)
        final_m1 = final_scores[:, :, :-1].argmax(1)
        total = nll_final
        sum_weights = 1.0
        confidence_loss = 0.0
        for i in range(L - 1):
            d0, d1 = pred["ref_descriptors0"][:, i], pred["ref_descriptors1"][:, i]
            scores_i, _, _, _ = self.log_assignment[i](d0, d1, mask0, mask1)
            nll_i = self._nll(scores_i, data)[0]
            weight = c.loss.gamma ** (L - i - 1) if c.loss.gamma > 0.0 else float(i + 1)
            total = total + nll_i * weight
            sum_weights += weight
            correct0 = (scores_i[:, :-1, :].argmax(-1) == final_m0).float()
            correct1 = (scores_i[:, :, :-1].argmax(1) == final_m1).float()
            l0, l1 = self.token_confidence[i](d0.detach(), d1.detach(), return_logits=True)
            bce0 = _masked_mean(_bce_with_logits(l0, correct0), mask0)
            bce1 = _masked_mean(_bce_with_logits(l1, correct1), mask1)
            confidence_loss = confidence_loss + (bce0 + bce1) / 2.0
        losses["confidence"] = confidence_loss / max(L - 1, 1)
        losses["total"] = total / sum_weights + c.loss.confidence_weight * losses["confidence"]
        return losses, {}


def _bce_with_logits(logits, target):
    """Elementwise BCE in logit space, the JAX package's stable form."""
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def _masked_mean(x, mask):
    """Mean over the last dimension, over `mask`'s True entries if given."""
    if mask is None:
        return x.mean(-1)
    return (x * mask).sum(-1) / mask.sum(-1).clamp(min=1)


def _exits(c0, c1, active0, active1, conf_th: float, depth_confidence: float) -> torch.Tensor:
    """(B,) depth rule: more than `depth_confidence` of an item's active
    tokens (both views) have confidence >= `conf_th`."""
    confident = ((c0 >= conf_th) & active0).sum(-1) + ((c1 >= conf_th) & active1).sum(-1)
    num = (active0.sum(-1) + active1.sum(-1)).clamp(min=1).float()
    return confident.float() / num > depth_confidence


def _width_round(active, z, conf, conf_th: float, width_confidence: float, stopped):
    """One width-pruning round of one view: (new active mask, the prune
    counter's increment). A token stays if its matchability passes
    1 - width_confidence or (with token confidences) it is not confident;
    stopped items keep their mask and count nothing."""
    keep = torch.sigmoid(z) > (1.0 - width_confidence)
    if conf is not None:  # low-confidence points are never pruned
        keep = keep | (conf <= conf_th)
    new_active = active & torch.where(stopped[:, None], active, keep)
    return new_active, (new_active & ~stopped[:, None]).to(torch.int32)
