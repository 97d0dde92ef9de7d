"""Quantization for the serving memory plane (port of the parts of
``paddle_tpu/quantization`` that serving runs): :mod:`.kv` (quantized KV
pages and weight-only int8) and the shared :func:`abs_max_scale`. QAT and
PTQ are not ported (ROADMAP.md A.13)."""

from paddle_tpu_torch.quantization import kv  # noqa: F401
from paddle_tpu_torch.quantization.observers import abs_max_scale

__all__ = ["abs_max_scale", "kv"]
