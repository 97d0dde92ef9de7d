"""RMSNorm forward and backward: CUDA kernels ``csrc/rms_norm.cu`` and
their plain twins.

Port of ``paddle_tpu/ops/pallas/rms_norm.py``. Same contract as the TPU
kernels: statistics in fp32 over the true width, ``y = x * r * w`` with
an fp32 weight, output in ``x``'s dtype; the backward recomputes ``r``
from ``x`` and gives ``dx`` in ``x``'s dtype and ``dw`` in fp32.
:class:`RMSNormFunction` joins the two for autograd.
"""

from __future__ import annotations

import contextlib

from typing import Dict, Tuple

import torch

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction", "launches", "launches_bwd"]

#: kernel launches made by :func:`rms_norm` (never by the plain twin)
launches = 0
#: kernel launches made by :func:`rms_norm_bwd`
launches_bwd = 0

# the backward's grid cap an SM (``kBwdBlocksPerSm`` in the .cu)
_BWD_BLOCKS_PER_SM = 2

# (device index, stream, row width) -> the backward's partial rows, reused
_partial_rows: Dict[Tuple[int, int, int], torch.Tensor] = {}


def _fast_ok(x: torch.Tensor, tensors, d: int) -> bool:
    """One pass over what the kernels take: x bf16 or fp32, every tensor
    contiguous on x's CUDA device, the fp32 weight (first of ``tensors``)
    of shape (d,) and the others of x's shape. Where it fails, the wrapper
    runs the detailed checks, which raise naming the fault."""
    dev = x.device
    if dev.type != "cuda" or x.dtype not in _launch.DTYPE_CODE \
            or not x.is_contiguous():
        return False
    w = tensors[0]
    if w.shape != (d,) or w.dtype != torch.float32:
        return False
    for i, t in enumerate(tensors):
        if t.device != dev or not t.is_contiguous() \
                or (i and (t.shape != x.shape or t.dtype != x.dtype)):
            return False
    return True


def _partials(dev: torch.device, stream: int, d: int) -> torch.Tensor:
    """The backward's partial rows for launches on ``stream`` at row width
    ``d``, one a block of the grid's cap (SMs x ``_BWD_BLOCKS_PER_SM``):
    kept and reused by every such call, whatever its rows. A buffer is
    never replaced or freed: a CUDA graph captured over a launch keeps its
    address (``jit.to_static``)."""
    key = (dev.index, stream, d)
    part = _partial_rows.get(key)
    if part is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # a buffer first needed inside a capture is allocated for the
        # default stream (the graph's replays are ordered after its work),
        # so that it comes from the common pool, not from the graph's
        # private pool, which it would outlive
        side = contextlib.nullcontext()
        if torch.cuda.is_current_stream_capturing():
            side = torch.cuda.stream(torch.cuda.default_stream(dev))
        with side:
            part = _partial_rows[key] = torch.empty(
                (sms * _BWD_BLOCKS_PER_SM, d), dtype=torch.float32,
                device=dev)
    return part


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """The TPU kernel's math in plain PyTorch (``_fwd_kernel``)."""
    xf = x.float()
    ms = xf.square().sum(dim=-1, keepdim=True) / x.shape[-1]
    return (xf * torch.rsqrt(ms + epsilon) * weight.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x``; same shape and dtype as ``x``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    global launches
    dev = x.device
    if dev.type == "cpu":
        return rms_norm_plain(x, weight, epsilon)
    d = x.shape[-1]
    w = weight if weight.dtype == torch.float32 else weight.float()
    if not _fast_ok(x, (w,), d):
        _launch.require(weight.shape == (d,), f"rms_norm: weight shape "
                        f"{tuple(weight.shape)} != ({d},)")
        _launch.check_cuda("rms_norm", x, w)
        _launch.dtype_code(x, "rms_norm")
    y = torch.empty_like(x)
    _launch.launch(
        "ptt_rms_norm_fwd", x.data_ptr(), w.data_ptr(), y.data_ptr(),
        x.numel() // max(d, 1), d, float(epsilon), _launch.DTYPE_CODE[x.dtype],
        _launch.stream_of(dev))
    launches += 1
    return y


def rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                       dy: torch.Tensor, epsilon: float = 1e-6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU backward kernel's math (``_bwd_kernel``): ``dx`` in x's
    dtype, ``dw`` in fp32."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    ms = xf.square().sum(dim=-1, keepdim=True) / d
    r = torch.rsqrt(ms + epsilon)
    t = dyf * weight.float()
    s = (t * xf).sum(dim=-1, keepdim=True)
    c = (r * r * r) * s / d
    dx = (r * t - c * xf).to(x.dtype)
    dw = (dyf * xf * r).reshape(-1, d).sum(dim=0)
    return dx, dw


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 epsilon: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rms_norm` for the cotangent ``dy`` (cast to
    x's dtype, as the TPU wrapper does). ``dw`` is fp32 and the same bits
    on every run: the kernels reduce it across rows in fixed orders, with
    no atomics. CPU tensors take the plain twin; CUDA tensors launch the
    kernels (the rows, then dw's sum over the blocks' partials), one
    count in ``launches_bwd``."""
    global launches_bwd
    dy = dy.to(x.dtype)
    dev = x.device
    if dev.type == "cpu":
        return rms_norm_bwd_plain(x, weight, dy, epsilon)
    d = x.shape[-1]
    w = weight if weight.dtype == torch.float32 else weight.float()
    if not _fast_ok(x, (w, dy), d):
        _launch.require(weight.shape == (d,), f"rms_norm_bwd: weight shape "
                        f"{tuple(weight.shape)} != ({d},)")
        _launch.require(dy.shape == x.shape, f"rms_norm_bwd: dy "
                        f"{tuple(dy.shape)} != x {tuple(x.shape)}")
        _launch.check_cuda("rms_norm_bwd", x, w, dy)
        _launch.dtype_code(x, "rms_norm_bwd")
    stream = _launch.stream_of(dev)
    part = _partials(dev, stream, d)
    dx = torch.empty_like(x)
    dw = torch.empty(d, dtype=torch.float32, device=dev)
    _launch.launch(
        "ptt_rms_norm_bwd", x.data_ptr(), w.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), part.data_ptr(), part.shape[0], dw.data_ptr(),
        x.numel() // max(d, 1), d, float(epsilon), _launch.DTYPE_CODE[x.dtype],
        stream)
    launches_bwd += 1
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """:func:`rms_norm` forward, :func:`rms_norm_bwd` backward (the TPU
    package's ``custom_vjp`` pair); ``dw`` comes back in the weight's
    dtype."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        x = x.contiguous()
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        return rms_norm(x, weight, epsilon)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, dy.contiguous(), ctx.epsilon)
        return dx, dw.to(weight.dtype), None
