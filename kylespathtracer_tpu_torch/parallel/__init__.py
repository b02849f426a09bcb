"""Sharded rendering and training on torch.distributed."""
