"""Quantized KV-page and weight helpers for the serving memory plane (port
of ``paddle_tpu/quantization/kv.py``).

Symmetric abs-max quantization of KV cache rows and of projection weights,
shared by

* :class:`paddle_tpu_torch.inference.paged_cache.PagedKVCache` (quantize on
  scatter, scales stored row-parallel to the pages),
* :mod:`paddle_tpu_torch.ops.kernels.quant` (ragged paged attention over
  quantized pages, CUDA kernel and plain twin) and
  :func:`paddle_tpu_torch.inference.attention.ragged_attention_xla`,
* :func:`paddle_tpu_torch.inference.decode_step.extract_params` (weight-only
  int8, dequantized in the decode step's projections).

KV scales are per token row, per KV head (``scale = absmax / qmax`` over
the head_dim axis), fp32, in an array parallel to the flat page layout
``[layers, rows, kv_heads]``: any code that moves KV rows moves the
matching scale rows with the same indices.

The arithmetic is the reference's operation for operation, in fp32: the
scale is ``absmax / qmax``, the inverse ``1 / max(scale, eps)`` (0 for a
zero row, whose scale is 0), int8 rounds half to even (``torch.round`` and
``jnp.round`` agree) and clamps to +-127, fp8 e4m3 clamps to +-448 and
rounds to nearest even in the cast.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.quantization.observers import abs_max_scale

__all__ = ["KV_QUANT_MODES", "resolve_mode", "storage_dtype", "scale_dtype",
           "page_row_bytes", "quantize_kv", "dequantize_kv",
           "quantize_weight_int8"]

#: Accepted ``serve_kv_quant`` flag values.
KV_QUANT_MODES = ("off", "int8", "fp8", "auto", "on")

_INT8_QMAX = 127.0
#: abs-max of float8_e4m3fn
_FP8_E4M3_MAX = 448.0

_EPS = 1e-12

_warned_fp8 = False


def _fp8_dtype():
    """The fp8 storage dtype, or None where this torch lacks it."""
    return getattr(torch, "float8_e4m3fn", None)


def resolve_mode(value) -> Optional[str]:
    """Map a ``serve_kv_quant`` value to None, ``'int8'`` or ``'fp8'``.

    ``auto`` and ``on`` pick int8. ``fp8`` without a float8 dtype in the
    running torch warns once and takes int8, as the reference does for a
    jax build without one."""
    global _warned_fp8
    mode = str(value).strip().lower() if value is not None else "off"
    if mode in ("off", "none", "false", ""):
        return None
    if mode not in KV_QUANT_MODES:
        raise ValueError(
            f"serve_kv_quant={value!r}: expected one of {KV_QUANT_MODES}")
    if mode in ("auto", "on"):
        return "int8"
    if mode == "fp8" and _fp8_dtype() is None:
        if not _warned_fp8:
            _warned_fp8 = True
            warnings.warn("serve_kv_quant=fp8: this torch has no "
                          "float8_e4m3fn dtype; falling back to int8 KV "
                          "pages", RuntimeWarning, stacklevel=2)
        return "int8"
    return mode


def storage_dtype(mode: str) -> torch.dtype:
    """Page storage dtype of a resolved quant mode."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        dt = _fp8_dtype()
        if dt is None:
            raise ValueError("fp8 KV pages need torch.float8_e4m3fn")
        return dt
    raise ValueError(f"unknown KV quant mode {mode!r}")


def scale_dtype() -> torch.dtype:
    """Dtype of the row-parallel scale arrays."""
    return torch.float32


def _qmax(mode: str) -> float:
    return _INT8_QMAX if mode == "int8" else _FP8_E4M3_MAX


def page_row_bytes(kv_heads: int, head_dim: int, dtype: torch.dtype,
                   mode: Optional[str] = None) -> int:
    """Bytes one KV token row costs in the paged memory plane: K and V
    storage plus, for quantized pools, the two fp32 scale entries per
    head. The one sizing formula behind ``PagedKVCache.bytes_per_block``
    and every equal-byte pool comparison."""
    per_row = 2 * kv_heads * head_dim * dtype.itemsize
    if mode is not None:
        per_row += 2 * kv_heads * scale_dtype().itemsize
    return per_row


def quantize_kv(x: torch.Tensor, mode: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV rows ``x[..., kv_heads, head_dim]``: ``(q, scale)`` with
    ``q`` of :func:`storage_dtype` and x's shape, ``scale`` fp32 with the
    trailing axis reduced away. A zero row gets scale 0 and quantizes to
    zeros, so dequant restores exact zeros."""
    qmax = _qmax(mode)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = absmax / qmax
    inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, _EPS),
                      torch.zeros_like(scale))
    scaled = xf * inv[..., None]
    if mode == "int8":
        q = torch.clamp(torch.round(scaled), -_INT8_QMAX, _INT8_QMAX)
    else:
        q = torch.clamp(scaled, -_FP8_E4M3_MAX, _FP8_E4M3_MAX)
    return q.to(storage_dtype(mode)), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q[..., kv, d] * scale[..., kv]``."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def quantize_weight_int8(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel abs-max int8 quantization of an ``[in, out]``
    projection weight: ``(q int8 [in, out], scale fp32 [out])``, so that
    dequant is one per-column multiply after the product,
    ``y = (x @ q) * scale``."""
    scale = abs_max_scale(w, dim=0).float()
    inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, _EPS),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(w.float() * inv[None, :]), -_INT8_QMAX,
                    _INT8_QMAX).to(torch.int8)
    return q, scale
