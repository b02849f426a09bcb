"""Kernel wrappers: each launches a hand-written CUDA kernel (csrc/) on CUDA
tensors and runs its plain PyTorch version on CPU tensors."""
