"""Parameters of the JAX package -> state dicts of the port.

`from_jax_params` takes the `params` collection of a flax model of
`gluefactory_tpu` (a nested dict of arrays, as `model.init(...)["params"]`
returns it, any array type that numpy reads) and returns a state dict that
the port's model of the same configuration loads with
`load_state_dict(..., strict=True)`.

The port's modules carry the official upstream names and layouts, so this
is the inverse of `gluefactory_tpu/compat/torch_conversion.py`:
  - flax Dense kernel (in, out) -> torch Linear weight (out, in);
  - flax Conv kernel (H, W, I, O) -> torch Conv2d weight (O, I, H, W);
  - LayerNorm scale -> weight;
  - LightGlue's fused Wqkv: the JAX columns are three blocks [q; k; v], each
    (head, dim); the official rows are (head, dim, q/k/v) interleaved.

LightGlue needs every per-layer head (`log_assignment_i` for each layer and
`token_confidence_i` for all but the last), which the JAX model creates with
`model.init(..., method="initialize")`. SuperGlue, the open SuperPoint
and ALIKED also need the `batch_stats` collection (BatchNorm running mean
and variance); ALIKED, DISK and the open SuperPoint go to the official
layouts (`aliked-n16.pth`, kornia's DISK, `superpoint_v6_from_tf.pth`),
the inverses of `convert_aliked`, `convert_disk` and
`convert_superpoint_open`; KeyNet + HardNet to kornia's `KeyNetHardNet`
names (`convert_keynet_hardnet`). SuperGlue's
attention heads go back from the JAX package's head-major channels to the
official head-fastest packing (the inverse of `_head_permutation`). GlueStick
likewise, under upstream GlueStick's names (`convert_gluestick`), LoFTR
under the official names (`convert_loftr`), DINOv2 under the torch-hub
names (`convert_dinov2`) and RoMa under romatch's (`convert_roma`, the
anchor decoder's flax attention fused back into `attn.qkv`), DeepLSD to the
port's native net or to the official package layout that `convert_deeplsd`
reads.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True, order="C"))


def _dense(p: dict, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(_np(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _tensor(_np(p["bias"]))


def _conv(p: dict, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(_np(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _tensor(_np(p["bias"]))


def _layer_norm(p: dict, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(_np(p["scale"]))
    sd[f"{prefix}.bias"] = _tensor(_np(p["bias"]))


def qkv_permutation(dim: int, num_heads: int) -> np.ndarray:
    """perm with jax_row[i] = official_row[perm[i]]: official row
    h*Dh*3 + dh*3 + j holds JAX row j*D + h*Dh + dh."""
    Dh = dim // num_heads
    j, h, dh = np.meshgrid(np.arange(3), np.arange(num_heads), np.arange(Dh), indexing="ij")
    return (h * Dh * 3 + dh * 3 + j).reshape(-1)


def superpoint_state_dict(params: dict) -> dict:
    """SuperPoint (vanilla): `conv1a` ... `convDb`, each a VGGBlock holding
    `Conv_0`, -> official `conv1a.weight`, ... ."""
    sd: dict = {}
    for name, block in params.items():
        _conv(block["Conv_0"], name, sd)
    return sd


def superpoint_open_state_dict(params: dict, batch_stats: dict) -> dict:
    """SuperPoint (open): `conv1a` ... `convDb`, each a VGGBlock holding
    `Conv_0` and `BatchNorm_0`, -> rpautrat's `backbone.{i}.{0,1}`,
    `detector.{0,1}`, `descriptor.{0,1}`, each `conv` and `bn` (inverse of
    `convert_superpoint_open`)."""
    sd: dict = {}
    heads = {"convPa": "detector.0", "convPb": "detector.1", "convDa": "descriptor.0",
             "convDb": "descriptor.1"}
    for name, block in params.items():  # conv{i}{a|b} -> backbone.{i-1}.{0|1}
        prefix = heads.get(name) or f"backbone.{int(name[4:-1]) - 1}.{'ab'.index(name[-1])}"
        _conv(block["Conv_0"], f"{prefix}.conv", sd)
        _batch_norm(block["BatchNorm_0"], batch_stats[name]["BatchNorm_0"], f"{prefix}.bn", sd)
    return sd


def aliked_state_dict(params: dict, batch_stats: dict) -> dict:
    """ALIKED -> the official layout (inverse of `convert_aliked`): the
    deformable convs' `kernel` to `regular_conv`, the score convs to
    `score_head.{0,2,4,6}`, SDDH's convs to `offset_conv.{0,2}`, its Dense
    `sf_conv` to a 1x1 conv; `agg_weights` as it is."""
    sd: dict = {}
    for b in ("block1", "block2", "block3", "block4"):
        p, stats = params[b], batch_stats[b]
        for i in (1, 2):
            conv = p[f"conv{i}"]
            if "offset_conv" in conv:
                _conv(conv["offset_conv"], f"{b}.conv{i}.offset_conv", sd)
                _conv({"kernel": conv["kernel"]}, f"{b}.conv{i}.regular_conv", sd)
            else:
                _conv(conv, f"{b}.conv{i}", sd)
            _batch_norm(p[f"bn{i}"], stats[f"bn{i}"], f"{b}.bn{i}", sd)
        if "downsample" in p:
            _conv(p["downsample"], f"{b}.downsample", sd)
    for i in (1, 2, 3, 4):
        _conv(params[f"conv{i}"], f"conv{i}", sd)
        _conv(params[f"score_conv{i}"], f"score_head.{2 * (i - 1)}", sd)
    head = params["desc_head"]
    _conv(head["offset_conv1"], "desc_head.offset_conv.0", sd)
    _conv(head["offset_conv2"], "desc_head.offset_conv.2", sd)
    sd["desc_head.sf_conv.weight"] = _tensor(_np(head["sf_conv"]["kernel"]).T[:, :, None, None])
    sd["desc_head.agg_weights"] = _tensor(_np(head["agg_weights"]))
    return sd


def disk_state_dict(params: dict) -> dict:
    """DISK -> kornia's layout (inverse of `convert_disk`): `unet.down_i` /
    `up_i` to `unet.path_down.{i}.conv` / `unet.path_up.{i}.conv`, the conv
    at index 2 (0 in the first block), the PReLU `gate` at 1."""
    sd: dict = {}
    for name, block in params["unet"].items():
        path, i = name.split("_")
        prefix = f"unet.path_{path}.{i}.conv"
        if "gate" in block:
            sd[f"{prefix}.1.weight"] = _tensor(_np(block["gate"]))
            _conv(block["conv"], f"{prefix}.2", sd)
        else:
            _conv(block["conv"], f"{prefix}.0", sd)
    return sd


def keynet_hardnet_state_dict(params: dict, batch_stats: dict) -> dict:
    """KeyNet + HardNet -> kornia's `KeyNetHardNet` names (inverse of
    `convert_keynet_hardnet`): KeyNet's block under
    `detector.model.feature_extractor.lb_block.conv{i}.{0,1}`, its last conv
    at `detector.model.last_conv.0`; HardNet's convs at
    `descriptor.descriptor.features.{0,3,...,15}` and 19, each affine-free
    BatchNorm right after."""
    sd: dict = {}
    kn, kn_stats = params["keynet"], batch_stats["keynet"]
    for i in range(3):
        prefix = f"detector.model.feature_extractor.lb_block.conv{i}"
        _conv(kn["block"][f"conv{i}"], f"{prefix}.0", sd)
        _batch_norm(kn["block"][f"bn{i}"], kn_stats["block"][f"bn{i}"], f"{prefix}.1", sd)
    _conv(kn["last_conv"], "detector.model.last_conv.0", sd)
    hn, hn_stats = params["hardnet"], batch_stats["hardnet"]
    names = [(f"conv{i}", f"bn{i}", 3 * i) for i in range(6)] + [("conv_final", "bn_final", 19)]
    for conv, bn, index in names:
        _conv(hn[conv], f"descriptor.descriptor.features.{index}", sd)
        prefix = f"descriptor.descriptor.features.{index + 1}"
        sd[f"{prefix}.running_mean"] = _tensor(_np(hn_stats[bn]["mean"]))
        sd[f"{prefix}.running_var"] = _tensor(_np(hn_stats[bn]["var"]))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _extractor_name(params: dict) -> str:
    """The extractor a pipeline's `extractor_model` params hold, by their
    keys: ALIKED's `desc_head`, DISK's `unet`, KeyNet's `keynet`, the open
    SuperPoint's `BatchNorm_0`, else the vanilla SuperPoint."""
    if "keynet" in params:
        return "keynet_affnet_hardnet"
    if "desc_head" in params:
        return "aliked"
    if "unet" in params:
        return "disk"
    if "BatchNorm_0" in params.get("conv1a", {}):
        return "superpoint_open"
    return "superpoint"


def lightglue_state_dict(params: dict, num_heads: int) -> dict:
    """LightGlue -> the official state dict layout."""
    sd: dict = {}
    _dense(params["input_proj"], "input_proj", sd)
    _dense(params["posenc"]["Wr"], "posenc.Wr", sd)
    n_layers = sum(1 for k in params if k.startswith("transformers_"))

    def ffn(p, prefix):
        _dense(p["fc1"], f"{prefix}.0", sd)
        _layer_norm(p["norm"], f"{prefix}.1", sd)
        _dense(p["fc2"], f"{prefix}.3", sd)

    for i in range(n_layers):
        layer = params[f"transformers_{i}"]
        t = f"transformers.{i}"
        sa, ca = layer["self_attn"], layer["cross_attn"]
        w = _np(sa["Wqkv"]["kernel"]).T  # (3D, in), rows [q; k; v]
        b = _np(sa["Wqkv"]["bias"])
        perm = qkv_permutation(w.shape[0] // 3, num_heads)
        w_off = np.empty_like(w)
        b_off = np.empty_like(b)
        w_off[perm] = w
        b_off[perm] = b
        sd[f"{t}.self_attn.Wqkv.weight"] = _tensor(w_off)
        sd[f"{t}.self_attn.Wqkv.bias"] = _tensor(b_off)
        _dense(sa["out_proj"], f"{t}.self_attn.out_proj", sd)
        ffn(sa["ffn"], f"{t}.self_attn.ffn")
        _dense(ca["to_qk"], f"{t}.cross_attn.to_qk", sd)
        _dense(ca["to_v"], f"{t}.cross_attn.to_v", sd)
        _dense(ca["out_proj"], f"{t}.cross_attn.to_out", sd)
        ffn(ca["ffn"], f"{t}.cross_attn.ffn")
    for i in range(n_layers):
        la = params[f"log_assignment_{i}"]
        _dense(la["final_proj"], f"log_assignment.{i}.final_proj", sd)
        _dense(la["matchability"], f"log_assignment.{i}.matchability", sd)
    for i in range(n_layers - 1):
        _dense(params[f"token_confidence_{i}"]["token"], f"token_confidence.{i}.token.0", sd)
    return sd


def head_fastest_permutation(dim: int, num_heads: int) -> np.ndarray:
    """perm with jax_channel[i] = official_channel[perm[i]]: official channel
    dh * H + h is JAX channel h * Dh + dh (`_head_permutation` of
    `torch_conversion.py`)."""
    Dh = dim // num_heads
    h, dh = np.meshgrid(np.arange(num_heads), np.arange(Dh), indexing="ij")
    return (dh * num_heads + h).reshape(-1)


def _batch_norm(p: dict, stats: dict, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(_np(p["scale"]))
    sd[f"{prefix}.bias"] = _tensor(_np(p["bias"]))
    sd[f"{prefix}.running_mean"] = _tensor(_np(stats["mean"]))
    sd[f"{prefix}.running_var"] = _tensor(_np(stats["var"]))
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _conv1d(p: dict, prefix: str, sd: dict) -> None:
    """flax Dense kernel (in, out) -> Conv1d weight (out, in, 1)."""
    sd[f"{prefix}.weight"] = _tensor(_np(p["kernel"]).T[..., None])
    sd[f"{prefix}.bias"] = _tensor(_np(p["bias"]))


def _mlp(p: dict, stats: dict, prefix: str, sd: dict) -> None:
    """Our MLP (dense_j, bn_j) -> official Sequential(Conv1d, BN, ReLU, ...,
    Conv1d): conv j at index 3j, its BatchNorm at 3j + 1."""
    n = sum(1 for k in p if k.startswith("dense_"))
    for j in range(n):
        _conv1d(p[f"dense_{j}"], f"{prefix}.{3 * j}", sd)
        if j < n - 1:
            _batch_norm(p[f"bn_{j}"], stats[f"bn_{j}"], f"{prefix}.{3 * j + 1}", sd)


def _attn_prop(p: dict, stats: dict, t: str, num_heads: int, sd: dict) -> None:
    """One AttentionalPropagation at prefix `t` in the official layout: the
    projections' rows and the merge's columns back to head-fastest."""
    for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
        w = _np(p[name]["kernel"]).T  # (out, in), rows head-major
        perm = head_fastest_permutation(w.shape[0], num_heads)
        w_off = np.empty_like(w)
        b_off = np.empty_like(w[:, 0])
        w_off[perm] = w
        b_off[perm] = _np(p[name]["bias"])
        sd[f"{t}.attn.proj.{j}.weight"] = _tensor(w_off[..., None])
        sd[f"{t}.attn.proj.{j}.bias"] = _tensor(b_off)
    wm = _np(p["merge"]["kernel"]).T  # (out, in), columns head-major
    wm_off = np.empty_like(wm)
    wm_off[:, head_fastest_permutation(wm.shape[1], num_heads)] = wm
    sd[f"{t}.attn.merge.weight"] = _tensor(wm_off[..., None])
    sd[f"{t}.attn.merge.bias"] = _tensor(_np(p["merge"]["bias"]))
    _mlp(p["mlp"], stats["mlp"], f"{t}.mlp", sd)


def superglue_state_dict(params: dict, num_heads: int, batch_stats: dict) -> dict:
    """SuperGlue -> the official state dict layout (inverse of
    `convert_superglue`)."""
    sd: dict = {}
    _mlp(params["kenc"], batch_stats["kenc"], "kenc.encoder", sd)
    n_layers = sum(1 for k in params if k.startswith("gnn_"))
    for i in range(n_layers):
        _attn_prop(params[f"gnn_{i}"], batch_stats[f"gnn_{i}"], f"gnn.layers.{i}", num_heads, sd)
    _conv1d(params["final_proj"], "final_proj", sd)
    sd["bin_score"] = _tensor(_np(params["bin_score"]).reshape(()))
    return sd


def gluestick_state_dict(params: dict, num_heads: int, batch_stats: dict) -> dict:
    """GlueStick -> upstream GlueStick's state dict layout (inverse of
    `convert_gluestick`), with the parameters upstream's checkpoint lacks:
    `gnn.line_layers.{i}.proj_node` / `proj_neigh` (line attention) and
    `inter_line_proj.{j}`."""
    sd: dict = {}
    _mlp(params["kenc"], batch_stats["kenc"], "kenc.encoder", sd)
    _mlp(params["lenc"]["encoder"], batch_stats["lenc"]["encoder"], "lenc.encoder", sd)
    n_gnn = sum(1 for k in params if k.startswith("gnn_"))
    for i in range(n_gnn):
        _attn_prop(params[f"gnn_{i}"], batch_stats[f"gnn_{i}"], f"gnn.layers.{i}.update",
                   num_heads, sd)
    for i in range(n_gnn // 2):
        p, t = params[f"line_layer_{i}"], f"gnn.line_layers.{i}"
        _mlp(p["mlp"], batch_stats[f"line_layer_{i}"]["mlp"], f"{t}.mlp", sd)
        for name in ("proj_node", "proj_neigh"):
            if name in p:
                _conv1d(p[name], f"{t}.{name}", sd)
    for name in ("final_proj", "final_line_proj", "input_proj"):
        if name in params:
            _conv1d(params[name], name, sd)
    j = 0
    while f"inter_line_proj_{j}" in params:
        _conv1d(params[f"inter_line_proj_{j}"], f"inter_line_proj.{j}", sd)
        j += 1
    sd["bin_score"] = _tensor(_np(params["bin_score"]).reshape(()))
    sd["line_bin_score"] = _tensor(_np(params["line_bin_score"]).reshape(()))
    return sd


def loftr_state_dict(params: dict, batch_stats: dict) -> dict:
    """LoFTR -> the official state dict layout (inverse of `convert_loftr`)."""
    sd: dict = {}
    bb, bs = params["backbone"], batch_stats["backbone"]

    def conv_bn(p, st, conv, bn):
        _conv(p["conv"], conv, sd)
        _batch_norm(p["bn"], st["bn"], bn, sd)

    conv_bn(bb["stem"], bs["stem"], "backbone.conv1", "backbone.bn1")
    for li in ("layer1", "layer2", "layer3"):
        for bi in range(2):
            p, st, base = bb[f"{li}_{bi}"], bs[f"{li}_{bi}"], f"backbone.{li}.{bi}"
            conv_bn(p["conv1"], st["conv1"], f"{base}.conv1", f"{base}.bn1")
            conv_bn(p["conv2"], st["conv2"], f"{base}.conv2", f"{base}.bn2")
            if "downsample" in p:
                conv_bn(p["downsample"], st["downsample"], f"{base}.downsample.0", f"{base}.downsample.1")
    for name in ("layer3_outconv", "layer2_outconv", "layer1_outconv"):
        _conv(bb[name], f"backbone.{name}", sd)
    for pre in ("layer2_outconv2", "layer1_outconv2"):
        conv_bn(bb[f"{pre}_0"], bs[f"{pre}_0"], f"backbone.{pre}.0", f"backbone.{pre}.1")
        _conv(bb[f"{pre}_1"], f"backbone.{pre}.3", sd)
    for stage in ("coarse", "fine"):
        i = 0
        while f"{stage}_{i}" in params:
            p, t = params[f"{stage}_{i}"], f"loftr_{stage}.layers.{i}"
            for name in ("q_proj", "k_proj", "v_proj", "merge"):
                _dense(p[name], f"{t}.{name}", sd)
            _dense(p["mlp_0"], f"{t}.mlp.0", sd)
            _dense(p["mlp_1"], f"{t}.mlp.2", sd)
            _layer_norm(p["norm1"], f"{t}.norm1", sd)
            _layer_norm(p["norm2"], f"{t}.norm2", sd)
            i += 1
    for name in ("down_proj", "merge_feat"):
        if name in params:
            _dense(params[name], f"fine_preprocess.{name}", sd)
    return sd


def dinov2_state_dict(params: dict) -> dict:
    """DINOv2 -> the official torch-hub layout (inverse of `convert_dinov2`)."""
    sd: dict = {}
    for name in ("cls_token", "pos_embed", "register_tokens"):
        if name in params:
            sd[name] = _tensor(_np(params[name]))
    _conv(params["patch_embed"], "patch_embed.proj", sd)
    i = 0
    while f"block_{i}" in params:
        p, b = params[f"block_{i}"], f"blocks.{i}"
        _layer_norm(p["norm1"], f"{b}.norm1", sd)
        _dense(p["qkv"], f"{b}.attn.qkv", sd)
        _dense(p["proj"], f"{b}.attn.proj", sd)
        sd[f"{b}.ls1.gamma"] = _tensor(_np(p["ls1"]))
        _layer_norm(p["norm2"], f"{b}.norm2", sd)
        _dense(p["fc1"], f"{b}.mlp.fc1", sd)
        _dense(p["fc2"], f"{b}.mlp.fc2", sd)
        sd[f"{b}.ls2.gamma"] = _tensor(_np(p["ls2"]))
        i += 1
    _layer_norm(params["norm"], "norm", sd)
    return sd


def roma_state_dict(params: dict, batch_stats: dict) -> dict:
    """RoMa (`{"net": ...}` or the net's own tree) -> romatch's layout at
    the top of the port's RoMa (inverse of `convert_roma` and
    `roma_fold_attention_heads`): the VGG at torchvision's indices, DINOv2
    under `encoder.dinov2`, the anchor decoder's flax attention (query, key,
    value (D, heads, head_dim), out (heads, head_dim, D), or flat (D, D))
    fused into `attn.qkv` rows [q; k; v] and `attn.proj`."""
    params, batch_stats = params.get("net", params), batch_stats.get("net", batch_stats)
    sd: dict = {}
    vgg, vgg_stats = params["vgg"], batch_stats["vgg"]
    for name in vgg:
        if name.startswith("conv"):
            i = int(name[4:])
            _conv(vgg[name], f"encoder.cnn.layers.{i}", sd)
            _batch_norm(vgg[f"bn{i}"], vgg_stats[f"bn{i}"], f"encoder.cnn.layers.{i + 1}", sd)
    for k, v in dinov2_state_dict(params["dinov2"]).items():
        sd[f"encoder.dinov2.{k}"] = v
    dec, dec_stats = params["decoder"], batch_stats["decoder"]
    _conv(dec["gp"]["pos_conv"], "decoder.gps.16.pos_conv", sd)
    for s in ("16", "8", "4", "2", "1"):
        _conv(dec[f"proj{s}_conv"], f"decoder.proj.{s}.0", sd)
        _batch_norm(dec[f"proj{s}_bn"], dec_stats[f"proj{s}_bn"], f"decoder.proj.{s}.1", sd)
        ref, ref_stats, r = dec[f"refiner{s}"], dec_stats[f"refiner{s}"], f"decoder.conv_refiner.{s}"
        blocks = ["block1"] + [f"hidden{j}" for j in range(sum(k.endswith("_dw") for k in ref) - 1)]
        for name in blocks:
            prefix = f"{r}.block1" if name == "block1" else f"{r}.hidden_blocks.{name[6:]}"
            _conv(ref[f"{name}_dw"], f"{prefix}.0", sd)
            _batch_norm(ref[f"{name}_bn"], ref_stats[f"{name}_bn"], f"{prefix}.1", sd)
            _conv(ref[f"{name}_pw"], f"{prefix}.3", sd)
        _conv(ref["out_conv"], f"{r}.out_conv", sd)
        _conv(ref["disp_emb"], f"{r}.disp_emb", sd)
    emdec, ed = dec["embedding_decoder"], "decoder.embedding_decoder"
    i = 0
    while f"block{i}" in emdec:
        p, b = emdec[f"block{i}"], f"{ed}.blocks.{i}"
        attn = p["attn"]
        D = _np(attn["query"]["kernel"]).shape[0]
        w = [_np(attn[k]["kernel"]).reshape(D, D).T for k in ("query", "key", "value")]
        sd[f"{b}.attn.qkv.weight"] = _tensor(np.concatenate(w, axis=0))
        sd[f"{b}.attn.qkv.bias"] = _tensor(np.concatenate(
            [_np(attn[k]["bias"]).reshape(D) for k in ("query", "key", "value")]))
        sd[f"{b}.attn.proj.weight"] = _tensor(_np(attn["out"]["kernel"]).reshape(D, D).T)
        sd[f"{b}.attn.proj.bias"] = _tensor(_np(attn["out"]["bias"]))
        _layer_norm(p["norm1"], f"{b}.norm1", sd)
        _layer_norm(p["norm2"], f"{b}.norm2", sd)
        _dense(p["fc1"], f"{b}.mlp.fc1", sd)
        _dense(p["fc2"], f"{b}.mlp.fc2", sd)
        i += 1
    _dense(emdec["to_out"], f"{ed}.to_out", sd)
    return sd


def deeplsd_state_dict(params: dict, batch_stats: dict | None) -> dict:
    """DeepLSD (`{"net": ...}` or the net's own tree; `net.`-prefixed keys
    for the former) -> the port's `DeepLSDNet` (the native flax names
    `_ConvBlock_i` / `Conv_i` in creation order: the down blocks, the
    bottleneck, then each decoder conv before its block, then the two
    heads) or `DeepLSDPackageNet` (`enc{i}_conv{j}` / `_bn{j}` ->
    `backbone.enc{i}.{3j}` / `.{3j+1}`; the heads' `{df|angle}_conv{j}` /
    `_bn{j}` / `_out` -> `{df|angle}_head.{3j}` / `.{3j+2}` / last),
    told apart by `enc0_conv0`."""
    if "net" in params:
        stats = (batch_stats or {}).get("net")
        return {f"net.{k}": v for k, v in deeplsd_state_dict(params["net"], stats).items()}
    sd: dict = {}
    if "enc0_conv0" in params:
        if batch_stats is None:
            raise ValueError("deeplsd package-layout: its BatchNorm statistics (batch_stats) are needed")
        for name in params:
            part, unit = name.rsplit("_", 1)
            if unit == "out" or not unit.startswith(("conv", "bn")):
                continue
            j = int(unit[2:]) if unit.startswith("bn") else int(unit[4:])
            if part in ("df", "angle"):
                prefix = f"{part}_head.{3 * j + (2 if unit.startswith('bn') else 0)}"
            else:
                prefix = f"backbone.{part}.{3 * j + (1 if unit.startswith('bn') else 0)}"
            if unit.startswith("bn"):
                _batch_norm(params[name], batch_stats[name], prefix, sd)
            else:
                _conv(params[name], prefix, sd)
        for part in ("df", "angle"):
            n_units = sum(k.startswith(f"{part}_conv") for k in params)
            _conv(params[f"{part}_out"], f"{part}_head.{3 * n_units}", sd)
        return sd
    n_blocks = sum(k.startswith("_ConvBlock_") for k in params)
    n = (n_blocks - 1) // 2
    for i in range(n_blocks):
        prefix = f"down.{i}" if i < n else "bottleneck" if i == n else f"up_blocks.{i - n - 1}"
        _conv(params[f"_ConvBlock_{i}"]["Conv_0"], f"{prefix}.0", sd)
        _conv(params[f"_ConvBlock_{i}"]["Conv_1"], f"{prefix}.2", sd)
    for i in range(n):
        _conv(params[f"Conv_{i}"], f"up.{i}", sd)
    _conv(params[f"Conv_{n}"], "df_head", sd)
    _conv(params[f"Conv_{n + 1}"], "angle_head", sd)
    return sd


def _matcher_name(params: dict) -> str:
    """The matcher a pipeline's `matcher_model` params hold, by their keys."""
    if "line_bin_score" in params:
        return "gluestick"
    if "bin_score" in params and "kenc" in params:
        return "superglue"
    if any(k.startswith("transformers_") for k in params):
        return "lightglue"
    if "backbone" in params and "coarse_0" in params:
        return "loftr"
    if "net" in params:
        return "roma"
    raise ValueError(f"no conversion for a matcher with parameters {sorted(params)}")


def from_jax_params(params: dict, model: str, num_heads: int = 4,
                    batch_stats: dict | None = None) -> dict:
    """JAX `params` of `model` ("superpoint", "superpoint_open", "aliked",
    "disk", "keynet_affnet_hardnet", "lightglue", "superglue", "gluestick", "loftr", "dinov2", "roma",
    "deeplsd" or "two_view_pipeline") -> the port's state dict. `num_heads` is the
    matcher's head count (its conf `num_heads`); `batch_stats` the JAX
    model's `batch_stats` collection (the BatchNorm statistics of
    SuperPoint-open, ALIKED, KeyNet + HardNet, SuperGlue, GlueStick, LoFTR's backbone,
    RoMa and DeepLSD's package layout). A
    pipeline's extractor is told apart by its parameters
    (`_extractor_name`), or is the wireframe around SuperPoint; its matcher
    likewise (GlueStick's `line_bin_score`, SuperGlue's `kenc` and
    `bin_score`, LightGlue's `transformers_i`, LoFTR's `backbone` and
    `coarse_0`, RoMa's `net`)."""
    if model == "superpoint":
        return superpoint_state_dict(params)
    if model == "disk":
        return disk_state_dict(params)
    if model in ("superpoint_open", "aliked", "keynet_affnet_hardnet"):
        if batch_stats is None:
            raise ValueError(f"{model}: its BatchNorm statistics (batch_stats) are needed")
        if model == "keynet_affnet_hardnet":
            return keynet_hardnet_state_dict(params, batch_stats)
        if model == "aliked":
            return aliked_state_dict(params, batch_stats)
        return superpoint_open_state_dict(params, batch_stats)
    if model == "lightglue":
        return lightglue_state_dict(params, num_heads)
    if model == "superglue":
        if batch_stats is None:
            raise ValueError("superglue: its BatchNorm statistics (batch_stats) are needed")
        return superglue_state_dict(params, num_heads, batch_stats)
    if model == "gluestick":
        if batch_stats is None:
            raise ValueError("gluestick: its BatchNorm statistics (batch_stats) are needed")
        return gluestick_state_dict(params, num_heads, batch_stats)
    if model == "loftr":
        if batch_stats is None:
            raise ValueError("loftr: its BatchNorm statistics (batch_stats) are needed")
        return loftr_state_dict(params, batch_stats)
    if model == "dinov2":
        return dinov2_state_dict(params)
    if model == "roma":
        if batch_stats is None:
            raise ValueError("roma: its BatchNorm statistics (batch_stats) are needed")
        return roma_state_dict(params, batch_stats)
    if model == "deeplsd":
        return deeplsd_state_dict(params, batch_stats)
    if model == "two_view_pipeline":
        sd: dict = {}
        for comp, sub in params.items():
            if comp == "extractor_model" and "point_extractor" in sub:  # the wireframe
                name, conv, sub = "extractor.point_extractor", "superpoint", sub["point_extractor"]
            elif comp == "extractor_model":
                name, conv = "extractor", _extractor_name(sub)
            elif comp == "matcher_model":
                name, conv = "matcher", _matcher_name(sub)
            else:
                raise KeyError(f"unexpected pipeline component {comp}")
            stats = (batch_stats or {}).get(comp)
            for k, v in from_jax_params(sub, conv, num_heads, stats).items():
                sd[f"{name}.{k}"] = v
        return sd
    raise ValueError(f"no conversion for model {model!r}")
