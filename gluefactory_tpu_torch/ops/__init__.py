"""Tensor ops and the hand-written CUDA kernels they dispatch to."""
