"""GlueStick: the joint point and line matcher (counterpart of
`gluefactory_tpu/models/matchers/gluestick.py`), inference and its loss.

Nodes are the wireframe's junctions first, then the keypoints
(`lines/wireframe.py`); `lines_junc_idx` (B, L, 2) indexes them. A keypoint
encoder and a line endpoint encoder feed 2 x `n_layers` of SuperGlue's
`AttentionalPropagation` (self, then cross); each self layer is followed by
`num_line_iterations` of a `LineLayer`, which passes messages along the
wireframe (each endpoint's message from its node, its partner endpoint and
its line encoding, then a mean over the endpoints at each node, or with
`line_attention` a softmax-weighted sum). Points and lines are assigned by
`log_double_softmax`, each with its learned dustbin; a line's score is the
better of its two endpoint orderings.

Parameters carry upstream GlueStick's names, which `convert_gluestick` of the
JAX package reads: `kenc.encoder.*`, `lenc.encoder.*`,
`gnn.layers.{i}.update.*`, `gnn.line_layers.{i}.mlp.*`, `final_proj`,
`final_line_proj`, `input_proj`, `bin_score`, `line_bin_score`; also
`gnn.line_layers.{i}.proj_node` / `proj_neigh` (`line_attention`) and
`inter_line_proj.{j}` (`inter_supervision`). BatchNorm follows SuperGlue's
port: by the running statistics unless `train`; with `train`, by the batch,
each BatchNorm's running statistics updated once a call of its MLP (the
encoders on view 0, then view 1; each layer on its view-0 call, then its
view-1 one), as flax updates `batch_stats`.

With `checkpointed` (and grad enabled), each attention layer call runs under
`torch.utils.checkpoint`, as the JAX model wraps `AttentionalPropagation` in
`nn.remat`; the line layers and the encoders are not checkpointed. The
inter-layer line assignments (`inter_supervision`) are taken from the
forward's activations.

The attention goes through `ops/attention.mha`, so the CUDA
`fused_attention` kernel on the card: 4 x `n_layers` launches a forward
(36 at 9 layer pairs), and as many again in a checkpointed backward's
recompute. The wireframe scatter is `index_add_` over the nodes.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.assignment import filter_matches, log_double_softmax
from ..base_model import BaseModel
from ..losses import masked_row_norm, nll_components
from ..metrics import matcher_metrics
from .superglue import (AttentionalPropagation, _pointwise, batch_norms, make_mlp,
                        normalize_keypoints_sg, propagate, run_mlp, update_running_stats)


def _run(mlp: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
    """The MLP on tokens; with `train`, BatchNorm by the batch and the
    running statistics updated after the call."""
    stats = [] if train else None
    out = run_mlp(mlp, x, stats)
    if train:
        update_running_stats(batch_norms(mlp), stats)
    return out


def _gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D) at node indices idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _scatter_nodes(values: torch.Tensor, idx: torch.Tensor, N: int) -> torch.Tensor:
    """Sum values (B, K, ...) into N node slots by idx (B, K) -> (B, N, ...)."""
    B, K = idx.shape
    flat = (idx + torch.arange(B, device=idx.device)[:, None] * N).reshape(-1)
    out = values.new_zeros((B * N,) + values.shape[2:])
    out.index_add_(0, flat, values.reshape((B * K,) + values.shape[2:]))
    return out.reshape((B, N) + values.shape[2:])


class EndPtEncoder(nn.Module):
    """Line endpoints (normalised), the offset to the other endpoint and the
    line score -> D per endpoint."""

    def __init__(self, dim: int, layers: list):
        super().__init__()
        self.encoder = make_mlp([5, *layers, dim])
        nn.init.constant_(self.encoder[-1].bias, 0.0)

    def forward(self, endpoints, scores, train: bool = False):
        B, L = endpoints.shape[:2]
        offset = endpoints[:, :, 1] - endpoints[:, :, 0]
        offsets = torch.stack([offset, -offset], dim=2)
        # upstream's score channel is scores.repeat(1, 2) against interleaved
        # endpoints: endpoint 2i + j gets s_{(2i + j) mod L}, not s_i
        inputs = torch.cat([endpoints.reshape(B, 2 * L, 2), offsets.reshape(B, 2 * L, 2),
                            scores.repeat(1, 2)[..., None]], dim=-1)
        return _run(self.encoder, inputs, train)


class LineLayer(nn.Module):
    def __init__(self, dim: int, attention: bool = False):
        super().__init__()
        self.dim = dim
        self.attention = attention
        self.mlp = make_mlp([3 * dim, 2 * dim, dim])
        if attention:
            self.proj_node = nn.Conv1d(dim, dim, kernel_size=1)
            self.proj_neigh = nn.Conv1d(2 * dim, dim, kernel_size=1)

    def forward(self, x, line_enc, junc_idx, line_mask=None, train: bool = False):
        B, N, D = x.shape
        L2 = junc_idx.shape[1]
        desc = _gather_nodes(x, junc_idx)  # (B, 2L, D)
        partner = desc.reshape(B, L2 // 2, 2, D).flip(2).reshape(B, L2, D)
        message = _run(self.mlp, torch.cat([desc, partner, line_enc], dim=-1), train)
        if line_mask is not None:
            w = line_mask.repeat_interleave(2, dim=-1).to(x.dtype)
        else:
            w = x.new_ones((B, L2))
        message = message * w[..., None]
        if self.attention:
            query = _gather_nodes(_pointwise(self.proj_node, x), junc_idx)
            key = _pointwise(self.proj_neigh, torch.cat([partner, line_enc], dim=-1))
            logit = (query * key).sum(-1).float() / self.dim ** 0.5
            logit = logit.masked_fill(w <= 0, float("-inf"))
            # one max over the whole batch (the normalisation cancels it)
            prob = torch.exp(logit - torch.clamp(logit.max(), min=-1e30))
            prob = prob.masked_fill(w <= 0, 0.0)
            denom = _scatter_nodes(prob, junc_idx, N)
            p = prob / (torch.gather(denom, 1, junc_idx) + 1e-8)
            update = _scatter_nodes(message * p[..., None].to(message.dtype), junc_idx, N)
        else:
            summed = _scatter_nodes(message, junc_idx, N)
            count = _scatter_nodes(w, junc_idx, N)
            update = summed / torch.clamp(count, min=1.0)[..., None]
        return x + update.to(x.dtype)


class _GNNLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.update = AttentionalPropagation(dim, num_heads)


class _GNN(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_layers: int, line_attention: bool):
        super().__init__()
        self.layers = nn.ModuleList([_GNNLayer(dim, num_heads) for _ in range(2 * n_layers)])
        self.line_layers = nn.ModuleList([LineLayer(dim, line_attention) for _ in range(n_layers)])


class GlueStick(BaseModel):
    default_conf = {
        "input_dim": 256,
        "descriptor_dim": 256,
        "weights": None,
        "keypoint_encoder": [32, 64, 128, 256],
        "n_layers": 9,  # pairs of (self + line, cross)
        "num_heads": 4,
        "num_line_iterations": 1,
        "line_attention": False,
        "filter_threshold": 0.2,
        "checkpointed": False,
        # layers (of the n_layers self/line blocks) whose line assignment is
        # also output, and supervised with the weights of loss.inter_supervision
        "inter_supervision": None,
        "loss": {
            "nll_weight": 1.0,
            "nll_balancing": 0.5,
            "inter_supervision": [0.3, 0.6],
        },
    }
    required_data_keys = [
        "keypoints0", "keypoints1", "descriptors0", "descriptors1",
        "keypoint_scores0", "keypoint_scores1",
        "lines0", "lines1", "lines_junc_idx0", "lines_junc_idx1",
        "line_scores0", "line_scores1",
    ]

    def _init(self, conf):
        d = conf.descriptor_dim
        if conf.input_dim != d:
            self.input_proj = nn.Conv1d(conf.input_dim, d, kernel_size=1)
        self.kenc = nn.Module()
        self.kenc.encoder = make_mlp([3, *conf.keypoint_encoder, d])
        nn.init.constant_(self.kenc.encoder[-1].bias, 0.0)
        self.lenc = EndPtEncoder(d, list(conf.keypoint_encoder))
        self.gnn = _GNN(d, conf.num_heads, conf.n_layers, conf.line_attention)
        self.final_proj = nn.Conv1d(d, d, kernel_size=1)
        self.final_line_proj = nn.Conv1d(d, d, kernel_size=1)
        self.inter_layers = tuple(conf.inter_supervision or ())
        if self.inter_layers:
            self.inter_line_proj = nn.ModuleList(
                [nn.Conv1d(d, d, kernel_size=1) for _ in self.inter_layers])
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.line_bin_score = nn.Parameter(torch.tensor(1.0))

    def _attn(self, layer, x, source, mask_q, mask_k, train: bool):
        return propagate(layer.update, x, source, mask_q, mask_k, train, self.conf.checkpointed)

    def _forward(self, data: dict, train: bool = False) -> dict:
        c = self.conf
        mask0, mask1 = data.get("keypoint_mask0"), data.get("keypoint_mask1")
        lmask0, lmask1 = data.get("line_mask0"), data.get("line_mask1")
        size0 = data["view0"]["image_size"] if "view0" in data else data["image_size0"]
        size1 = data["view1"]["image_size"] if "view1" in data else data["image_size1"]
        B, L0 = data["lines0"].shape[:2]
        L1 = data["lines1"].shape[1]
        junc_idx0 = data["lines_junc_idx0"].reshape(B, 2 * L0).long()
        junc_idx1 = data["lines_junc_idx1"].reshape(B, 2 * L1).long()

        desc0, desc1 = data["descriptors0"], data["descriptors1"]
        if c.input_dim != c.descriptor_dim:
            desc0 = _pointwise(self.input_proj, desc0)
            desc1 = _pointwise(self.input_proj, desc1)

        def encode(kpts, size, scores, desc):
            p = normalize_keypoints_sg(kpts, size)
            enc_in = torch.cat([p, scores[..., None].to(p.dtype)], dim=-1).to(desc.dtype)
            return desc + _run(self.kenc.encoder, enc_in, train)

        x0 = encode(data["keypoints0"], size0, data["keypoint_scores0"], desc0)
        x1 = encode(data["keypoints1"], size1, data["keypoint_scores1"], desc1)

        def encode_lines(lines, L, size, scores, desc):
            ln = normalize_keypoints_sg(lines.reshape(B, 2 * L, 2), size).reshape(B, L, 2, 2)
            return self.lenc(ln.to(desc.dtype), scores.to(desc.dtype), train)

        line_enc0 = encode_lines(data["lines0"], L0, size0, data["line_scores0"], desc0)
        line_enc1 = encode_lines(data["lines1"], L1, size1, data["line_scores1"], desc1)

        inter = {}
        for i, layer in enumerate(self.gnn.layers):
            if i % 2 == 0:  # self, then the line layer
                x0 = self._attn(layer, x0, x0, mask0, mask0, train)
                x1 = self._attn(layer, x1, x1, mask1, mask1, train)
                ll = self.gnn.line_layers[i // 2]
                for _ in range(c.num_line_iterations):
                    x0 = ll(x0, line_enc0, junc_idx0, lmask0, train)
                    x1 = ll(x1, line_enc1, junc_idx1, lmask1, train)
            else:  # cross, x0's from the old x1
                x0, x1 = (self._attn(layer, x0, x1, mask0, mask1, train),
                          self._attn(layer, x1, x0, mask1, mask0, train))
                if (i // 2) in self.inter_layers:
                    inter[i // 2] = (x0, x1)

        mdesc0 = _pointwise(self.final_proj, x0).float()
        mdesc1 = _pointwise(self.final_proj, x1).float()
        kp_scores = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1) / c.descriptor_dim ** 0.5
        kp_scores = log_double_softmax(kp_scores, self.bin_score, mask0, mask1)
        m0, m1, ms0, ms1 = filter_matches(kp_scores, c.filter_threshold, mask0, mask1)
        pred = {"log_assignment": kp_scores, "matches0": m0, "matches1": m1,
                "matching_scores0": ms0, "matching_scores1": ms1}

        ls, lm0, lm1, lms0, lms1, raw = self._line_matches(x0, x1, junc_idx0, junc_idx1, lmask0,
                                                           lmask1, self.final_line_proj)
        pred.update(line_log_assignment=ls, line_matches0=lm0, line_matches1=lm1,
                    line_matching_scores0=lms0, line_matching_scores1=lms1, raw_line_scores=raw)
        for j, layer_idx in enumerate(self.inter_layers):
            if layer_idx not in inter:
                continue
            xi0, xi1 = inter[layer_idx]
            ls_i, lm0_i, lm1_i, lms0_i, lms1_i, _ = self._line_matches(
                xi0, xi1, junc_idx0, junc_idx1, lmask0, lmask1, self.inter_line_proj[j])
            pred[f"line_{layer_idx}_log_assignment"] = ls_i
            pred[f"line_{layer_idx}_matches0"] = lm0_i
            pred[f"line_{layer_idx}_matches1"] = lm1_i
            pred[f"line_{layer_idx}_matching_scores0"] = lms0_i
            pred[f"line_{layer_idx}_matching_scores1"] = lms1_i
        return pred

    def _line_matches(self, x0, x1, junc_idx0, junc_idx1, lmask0, lmask1, proj):
        c = self.conf
        mld0 = _pointwise(proj, _gather_nodes(x0, junc_idx0)).float()
        mld1 = _pointwise(proj, _gather_nodes(x1, junc_idx1)).float()
        B = mld0.shape[0]
        L0, L1 = mld0.shape[1] // 2, mld1.shape[1] // 2
        s = torch.einsum("bnd,bmd->bnm", mld0, mld1) / c.descriptor_dim ** 0.5
        s = s.reshape(B, L0, 2, L1, 2)
        raw = 0.5 * torch.maximum(s[:, :, 0, :, 0] + s[:, :, 1, :, 1],
                                  s[:, :, 0, :, 1] + s[:, :, 1, :, 0])
        scores = log_double_softmax(raw, self.line_bin_score, lmask0, lmask1)
        lm0, lm1, lms0, lms1 = filter_matches(scores, c.filter_threshold, lmask0, lmask1)
        return scores, lm0, lm1, lms0, lms1, raw

    def _sub_loss(self, losses, la, data, bin_score, prefix="", layer=-1, mask=None):
        """One assignment's NLL under `{prefix}{layer_}assignment_nll`; returns
        its share of the total (nll_weight times the layer's weight). The
        diagnostics only for the final assignments."""
        c = self.conf
        suffix = "" if layer == -1 else f"{layer}_"
        layer_weight = 1.0 if layer == -1 else c.loss.inter_supervision[self.inter_layers.index(layer)]
        nll_pos, nll_neg, num_pos, num_neg = nll_components(
            la, data[f"gt_{prefix}assignment"], data[f"gt_{prefix}matches0"],
            data[f"gt_{prefix}matches1"], per_side_clamp=False)
        nll = c.loss.nll_balancing * nll_pos + (1.0 - c.loss.nll_balancing) * nll_neg
        losses[prefix + suffix + "assignment_nll"] = nll
        contribution = nll * c.loss.nll_weight * layer_weight if c.loss.nll_weight > 0 else 0.0
        if suffix == "":
            losses[prefix + "num_matchable"] = num_pos
            losses[prefix + "num_unmatchable"] = num_neg
            losses[prefix + "sinkhorn_norm"] = masked_row_norm(la, mask)
            losses[prefix + "bin_score"] = bin_score.detach().expand(la.shape[0])
        return contribution

    def loss(self, pred: dict, data: dict, train: bool = False):
        """The point, line and inter-layer line NLLs with their diagnostics;
        `matcher_metrics` for points, lines and inter-layer lines at eval."""
        losses, total = {}, 0.0
        if pred["matches0"].shape[1] > 0 and pred["matches1"].shape[1] > 0:
            total = total + self._sub_loss(losses, pred["log_assignment"], data, self.bin_score,
                                           mask=data.get("keypoint_mask0"))
        has_lines = data["lines0"].shape[1] > 0 and data["lines1"].shape[1] > 0
        if "gt_line_assignment" in data and has_lines:
            total = total + self._sub_loss(losses, pred["line_log_assignment"], data,
                                           self.line_bin_score, prefix="line_",
                                           mask=data.get("line_mask0"))
            for layer_idx in self.inter_layers:
                key = f"line_{layer_idx}_log_assignment"
                if key in pred:
                    total = total + self._sub_loss(losses, pred[key], data, self.line_bin_score,
                                                   prefix="line_", layer=layer_idx)
        losses["total"] = total
        metrics = {}
        if not train:
            if pred["matches0"].shape[1] > 0 and pred["matches1"].shape[1] > 0:
                metrics.update(matcher_metrics(pred, data))
            if "line_matches0" in pred and "gt_line_matches0" in data and has_lines:
                metrics.update(matcher_metrics(pred, data, prefix="line_"))
                for layer_idx in self.inter_layers:
                    if f"line_{layer_idx}_matches0" in pred:
                        metrics.update(matcher_metrics(pred, data, prefix=f"line_{layer_idx}_",
                                                       prefix_gt="line_"))
        return losses, metrics
