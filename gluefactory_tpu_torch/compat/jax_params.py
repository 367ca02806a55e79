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
`model.init(..., method="initialize")`.
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


def from_jax_params(params: dict, model: str, num_heads: int = 4) -> dict:
    """JAX `params` of `model` ("superpoint", "lightglue" or
    "two_view_pipeline" holding those two) -> the port's state dict.
    `num_heads` is LightGlue's head count (its conf `num_heads`)."""
    if model == "superpoint":
        return superpoint_state_dict(params)
    if model == "lightglue":
        return lightglue_state_dict(params, num_heads)
    if model == "two_view_pipeline":
        sd: dict = {}
        for comp, sub in params.items():
            if not comp.endswith("_model"):
                raise KeyError(f"unexpected pipeline component {comp}")
            name = comp[: -len("_model")]
            kind = "superpoint" if name == "extractor" else "lightglue"
            for k, v in from_jax_params(sub, kind, num_heads).items():
                sd[f"{name}.{k}"] = v
        return sd
    raise ValueError(f"no conversion for model {model!r}")
