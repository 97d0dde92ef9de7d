"""The port's hand-written CUDA kernels and their wrappers.

Each module here pairs the kernels of one TPU module, from
``paddle_tpu_torch/csrc``, with

* a plain PyTorch twin of each kernel's function (used for CPU tensors — the
  CPU tests hold it against the JAX reference — and, on the card, only by
  ``chip_smoke.py`` to check the kernel);
* a wrapper that, for a CUDA tensor, checks device, dtype, shape and
  contiguity, allocates the output and launches the kernel, or raises —
  it never falls back to the twin;
* a launch counter, a plain integer the wrapper bumps once per kernel
  launch (and nowhere else), so a run can show which kernels it went
  through: ``launches`` for a module's forward kernel, ``launches_bwd``
  for its backward kernel (the grouped GEMMs also count ``gmm2`` and
  ``tgmm`` apart, and the exchanges their three kernels).

The mirror of ``paddle_tpu/ops/pallas/<name>.py`` is
``paddle_tpu_torch/ops/kernels/<name>.py``; the KV-page remote copy of
``paddle_tpu/inference/kv_handoff.py`` is ``kv_handoff.py`` here.
"""

from __future__ import annotations

from typing import Dict

from paddle_tpu_torch.ops.kernels import (async_collectives, flash_attention,
                                          fused_block, grouped_gemm,
                                          kv_handoff, paged_attention, quant,
                                          ragged_paged_attention, rms_norm,
                                          selective_scan)

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

#: kernel name -> (wrapper module, name of its integer launch counter)
KERNELS = {
    "ragged_paged_attention": (ragged_paged_attention, "launches"),
    "flash_attention_fwd": (flash_attention, "launches"),
    "flash_attention_bwd": (flash_attention, "launches_bwd"),
    "rms_norm_fwd": (rms_norm, "launches"),
    "rms_norm_bwd": (rms_norm, "launches_bwd"),
    "fused_block_fwd": (fused_block, "launches"),
    "gmm_fwd": (grouped_gemm, "launches"),
    "gmm_bwd": (grouped_gemm, "launches_bwd"),
    "gmm2": (grouped_gemm, "launches_gmm2"),
    "tgmm": (grouped_gemm, "launches_tgmm"),
    "paged_attention": (paged_attention, "launches"),
    "selective_scan": (selective_scan, "launches"),
    "selective_scan_bwd": (selective_scan, "launches_bwd"),
    "ragged_paged_attention_quant": (quant, "launches"),
    "flash_attention_seg_fwd": (flash_attention, "launches_seg"),
    "flash_attention_seg_bwd": (flash_attention, "launches_seg_bwd"),
    "ring_kv_rotate": (async_collectives, "launches"),
    "tiled_a2a": (async_collectives, "launches_a2a"),
    "fused_a2a_expert_mlp": (async_collectives, "launches_fused"),
    "kv_pages_remote_copy": (kv_handoff, "launches"),
}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
