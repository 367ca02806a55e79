"""LightGlue configured for a feature type (counterpart of
`gluefactory_tpu/models/matchers/lightglue_pretrained.py`): `features`
picks the input width and `add_scale_ori` of the official release's
weights for SuperPoint, DISK, ALIKED or SIFT, before the rest of the conf
and LightGlue's defaults. The weights come by `weights_file`: a state dict
under the official names (the port's LightGlue carries them), such as
`compat/jax_params.from_jax_params` writes from converted JAX parameters."""

from __future__ import annotations

from .lightglue import LightGlue

FEATURE_CONFS = {
    "superpoint": {"input_dim": 256, "add_scale_ori": False},
    "disk": {"input_dim": 128, "add_scale_ori": False},
    "aliked": {"input_dim": 128, "add_scale_ori": False},
    "sift": {"input_dim": 128, "add_scale_ori": True},
}


class LightGluePretrained(LightGlue):
    default_conf = {
        "features": "superpoint",
        "weights_file": None,  # a state dict (torch.save) under the official names
        "depth_confidence": 0.95,
        "width_confidence": 0.99,
        "filter_threshold": 0.1,
        "trainable": False,
    }

    @classmethod
    def resolve_conf(cls, conf=None):
        conf = conf.to_dict() if hasattr(conf, "to_dict") else dict(conf or {})
        feats = conf.get("features", cls.default_conf["features"])
        return super().resolve_conf({**FEATURE_CONFS[feats], **conf})
