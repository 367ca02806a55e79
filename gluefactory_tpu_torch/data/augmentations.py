"""Photometric augmentations (counterpart of
`gluefactory_tpu/data/augmentations.py`) on float32 HWC RGB images in
[0, 1], with a numpy generator for reproducibility.

Only `identity` is ported. The JAX package's `dark` and `lg` families are
cv2 calls throughout (Gaussian and motion blur, JPEG round trips, CLAHE, the
HSV hue shift), and the port does not depend on OpenCV: both raise
`NotImplementedError`.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Config, merge


class BaseAugmentation:
    default_conf: dict = {"p": 1.0}

    def __init__(self, conf=None):
        self.conf = merge(Config(self.default_conf), conf or {})

    def __call__(self, image: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        """A grayscale image (C = 1) is repeated to three channels first."""
        if rng is None:
            rng = np.random.default_rng()
        if image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        return self.apply(image, rng)

    def apply(self, image, rng):
        return image


class IdentityAugmentation(BaseAugmentation):
    pass


class _NeedsOpenCV(BaseAugmentation):
    def __init__(self, conf=None):
        raise NotImplementedError(
            f"photometric augmentation {self.name!r} is not ported: its blur, JPEG, CLAHE and hue "
            "operations need OpenCV (cv2), which the port does not use; use 'identity'")


class DarkAugmentation(_NeedsOpenCV):
    name = "dark"


class LGAugmentation(_NeedsOpenCV):
    name = "lg"


augmentations = {
    "identity": IdentityAugmentation,
    "dark": DarkAugmentation,
    "lg": LGAugmentation,
}
