"""On-device SIFT under the reference's `sift_kornia` name (counterpart of
`gluefactory_tpu/models/extractors/sift_kornia.py`): `sift` with
`backend: "jax"` pinned, so the DoG pipeline of `ops/sift.py` runs on the
device and recipes written against that name run unchanged. It needs no
kornia."""

from __future__ import annotations

from .sift import SIFT


class SIFTKornia(SIFT):
    default_conf = {
        **SIFT.default_conf,
        "backend": "jax",
        "max_num_keypoints": 4096,
        "rootsift": True,
    }
