"""PyTorch/CUDA port of gluefactory_tpu: the SuperPoint + LightGlue two-view
inference path, with hand-written CUDA kernels for its attention."""
