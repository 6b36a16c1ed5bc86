"""Attention and GroupNorm kernels (CUDA, with plain PyTorch versions) and
small tensor ops."""
