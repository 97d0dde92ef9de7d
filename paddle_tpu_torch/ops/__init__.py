"""Operators of the port; hand-written kernels live in
:mod:`paddle_tpu_torch.ops.kernels`."""
