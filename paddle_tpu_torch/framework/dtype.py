"""Dtype names (port of ``paddle_tpu/framework/dtype.py``): the string
names the configs use, mapped to torch dtypes."""

from __future__ import annotations

import torch

__all__ = ["to_torch_dtype"]

_BY_NAME = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` (or a torch dtype) -> ``torch.bfloat16``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _BY_NAME[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None

