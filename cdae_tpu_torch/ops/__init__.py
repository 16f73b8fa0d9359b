"""Tensor ops of the port: top-k, ranking metrics and the CUDA kernels."""
