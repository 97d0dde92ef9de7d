"""Autograd helpers of the port (``paddle_tpu/autograd/``): activation
recomputation."""

from paddle_tpu_torch.autograd.recompute import recompute

__all__ = ["recompute"]
