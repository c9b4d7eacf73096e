"""Sharded rendering and training over torch.distributed ranks."""
