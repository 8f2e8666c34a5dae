"""Kernels written by hand for NVIDIA Hopper, each beside its plain
PyTorch version (which CPU tensors take)."""
