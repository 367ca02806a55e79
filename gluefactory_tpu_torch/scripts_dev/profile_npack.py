"""The N-packed 3x3 conv kernel (`csrc/conv3x3_npack.cu`: the three row taps
packed side by side in N = 192, the column taps folded into K, partials P
over ROWS + 2 rows in an f32 scratch, then the row-shifted sum) against the
library conv at SuperPoint's conv1b shape (8 x 1024^2 x 64, bf16).
Counterpart of the JAX package's `scripts_dev/profile_npack.py`.

    python -m gluefactory_tpu_torch.scripts_dev.profile_npack

Prints one JSON line as it grows: lib_ms, maxdiff, npack_ms, plain_ms,
bound_ms, card (see `conv_study`).
"""

from __future__ import annotations

from ..ops import cuda_conv3x3
from . import conv_study


def main(device="cuda", shape=conv_study.SHAPE) -> dict:
    return conv_study.run("npack_ms", cuda_conv3x3.npack_conv3x3,
                          cuda_conv3x3.npack_conv3x3_plain, device, shape)


if __name__ == "__main__":
    main()
