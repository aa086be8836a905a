"""Ops of the PyTorch port: attention, optimizers, and the wrappers of the CUDA kernels."""
