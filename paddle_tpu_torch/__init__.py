"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module paths (``paddle_tpu_torch/inference/decode_step.py`` is the
counterpart of ``paddle_tpu/inference/decode_step.py``) and holds its
results against it. Plain tensor code is PyTorch; every Pallas kernel on a
ported path is a CUDA C++ kernel for Hopper (``sm_90a``) under
``paddle_tpu_torch/csrc``, built with ``nvcc`` at first use and bound with
``ctypes`` (:mod:`paddle_tpu_torch.ops.kernels`).

Entry points run on the first CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of quietly
running on the CPU. On CPU tensors each kernel wrapper runs its plain
PyTorch twin — that is how the CPU tests hold the port against JAX.

The package imports ``torch`` and never ``jax`` or ``paddle_tpu``.
"""

from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.framework.random import seed

__all__ = ["resolve_device", "seed"]

__version__ = "0.1.0"
