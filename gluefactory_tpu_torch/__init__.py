"""PyTorch/CUDA port of gluefactory_tpu: SuperPoint + LightGlue two-view
inference and stage-1 homography training, with hand-written CUDA kernels
for the JAX package's Pallas kernels."""

import logging

logger = logging.getLogger("gluefactory_tpu_torch")


def _setup_logger() -> None:
    formatter = logging.Formatter(
        fmt="[%(asctime)s %(name)s %(levelname)s] %(message)s", datefmt="%m/%d/%Y %H:%M:%S"
    )
    handler = logging.StreamHandler()
    handler.setFormatter(formatter)
    handler.setLevel(logging.INFO)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        logger.addHandler(handler)
    logger.propagate = False


_setup_logger()
