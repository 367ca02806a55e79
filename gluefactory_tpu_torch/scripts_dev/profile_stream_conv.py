"""The streaming 3x3 conv kernel (`csrc/conv3x3_stream.cu`: nine per-tap
products read straight from a shifted patch, no scratch) against the
library conv at SuperPoint's conv1b shape (8 x 1024^2 x 64, bf16).
Counterpart of the JAX package's `scripts_dev/profile_stream_conv.py`.

    python -m gluefactory_tpu_torch.scripts_dev.profile_stream_conv

Prints one JSON line as it grows: lib_ms, maxdiff, stream_ms, plain_ms,
bound_ms, card (see `conv_study`).
"""

from __future__ import annotations

from ..ops import cuda_conv3x3
from . import conv_study


def main(device="cuda", shape=conv_study.SHAPE) -> dict:
    return conv_study.run("stream_ms", cuda_conv3x3.stream_conv3x3,
                          cuda_conv3x3.stream_conv3x3_plain, device, shape)


if __name__ == "__main__":
    main()
