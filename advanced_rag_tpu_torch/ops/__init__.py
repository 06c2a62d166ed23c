"""Tensor operations of the port; ``*_kernels.py`` hold the CUDA kernels'
wrappers beside their plain PyTorch versions."""
