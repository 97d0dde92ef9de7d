"""The port's hand-written CUDA kernels and their wrappers.

Each module here pairs one kernel from ``paddle_tpu_torch/csrc`` with

* a plain PyTorch twin of the same function (used for CPU tensors — the
  CPU tests hold it against the JAX reference — and, on the card, only by
  ``chip_smoke.py`` to check the kernel);
* a wrapper that, for a CUDA tensor, checks device, dtype, shape and
  contiguity, allocates the output and launches the kernel, or raises —
  it never falls back to the twin;
* ``launches``, a plain integer the wrapper bumps once per kernel launch
  (and nowhere else), so a run can show which kernels it went through.

The mirror of ``paddle_tpu/ops/pallas/<name>.py`` is
``paddle_tpu_torch/ops/kernels/<name>.py``.
"""

from __future__ import annotations

from typing import Dict

from paddle_tpu_torch.ops.kernels import (flash_attention,
                                          ragged_paged_attention, rms_norm)

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

#: kernel name -> wrapper module (each has an integer ``launches``)
KERNELS = {
    "ragged_paged_attention": ragged_paged_attention,
    "flash_attention_fwd": flash_attention,
    "rms_norm_fwd": rms_norm,
}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
