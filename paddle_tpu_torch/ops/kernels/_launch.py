"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["DTYPE_CODE", "dtype_code", "require", "check_cuda", "stream_of",
           "launch", "head_dim_bucket"]

#: dtype codes of the C interface (``csrc/common.cuh`` PttDtype)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODE[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the "
                        f"kernel (float32 or bfloat16)") from None


def head_dim_bucket(d: int) -> int:
    """The padded head dim (64, 128 or 256) that the CUDA-core attention
    kernels are instantiated at for head dim ``d``, a multiple of 16 up to
    256 (those kernels take the real ``d`` and mask the columns past it);
    0 where ``d`` is not one. ``csrc/common.cuh:head_dim_bucket`` is the
    kernels' copy."""
    if d < 16 or d > 256 or d % 16:
        return 0
    return 64 if d <= 64 else 128 if d <= 128 else 256


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got one on "
                             f"{t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")
    return dev


def stream_of(device: torch.device) -> int:
    """The current stream of ``device`` as a ``cudaStream_t`` integer,
    read without building a ``torch.cuda.Stream`` object (a few
    microseconds of host time on every launch otherwise)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def launch(fn_name: str, *args) -> None:
    """Call the C entry ``fn_name`` and raise on the CUDA error it
    returns (a refused launch never runs and would not show up in a later
    synchronize)."""
    lib = _build.library()
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err} ({msg})")
