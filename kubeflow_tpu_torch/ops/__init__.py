"""Attention ops of the PyTorch port and the wrappers of their CUDA kernels."""
