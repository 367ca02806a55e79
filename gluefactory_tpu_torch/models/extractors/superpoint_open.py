"""Open-source SuperPoint (rpautrat's re-training, MIT licence): the
BatchNorm variant of the VGG SuperPoint (counterpart of
`gluefactory_tpu/models/extractors/superpoint_open.py`).

The shared `SuperPoint` with `variant: open` (BatchNorm after every
conv, rpautrat's parameter names) and the reference's defaults.
"""

from __future__ import annotations

from .superpoint import SuperPoint


class SuperPointOpen(SuperPoint):
    default_conf = {
        "variant": "open",
        "descriptor_dim": 256,
        "nms_radius": 4,
        "detection_threshold": 0.005,
    }
