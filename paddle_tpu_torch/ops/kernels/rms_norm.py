"""RMSNorm forward and backward: CUDA kernels ``csrc/rms_norm.cu`` and
their plain twins.

Port of ``paddle_tpu/ops/pallas/rms_norm.py``. Same contract as the TPU
kernels: statistics in fp32 over the true width, ``y = x * r * w`` with
an fp32 weight, output in ``x``'s dtype; the backward recomputes ``r``
from ``x`` and gives ``dx`` in ``x``'s dtype and ``dw`` in fp32.
:class:`RMSNormFunction` joins the two for autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction", "launches", "launches_bwd"]

#: kernel launches made by :func:`rms_norm` (never by the plain twin)
launches = 0
#: kernel launches made by :func:`rms_norm_bwd`
launches_bwd = 0

# rows per block of the backward's first stage (``kBwdRows`` in the .cu)
_BWD_ROWS = 32


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
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, epsilon)
    d = x.shape[-1]
    _launch.require(weight.shape == (d,),
                    f"rms_norm: weight shape {tuple(weight.shape)} != ({d},)")
    w = weight if weight.dtype == torch.float32 else weight.float()
    dev = _launch.check_cuda("rms_norm", x, w)
    code = _launch.dtype_code(x, "rms_norm")
    y = torch.empty_like(x)
    _launch.launch("ptt_rms_norm_fwd", x.data_ptr(), w.data_ptr(),
                   y.data_ptr(), x.numel() // max(d, 1), d, float(epsilon),
                   code, _launch.stream_of(dev))
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
    on every run: the kernel reduces it across rows in two fixed-order
    stages, with no atomics. CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    global launches_bwd
    dy = dy.to(x.dtype)
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, dy, epsilon)
    d = x.shape[-1]
    _launch.require(weight.shape == (d,),
                    f"rms_norm_bwd: weight shape {tuple(weight.shape)} != "
                    f"({d},)")
    _launch.require(dy.shape == x.shape,
                    f"rms_norm_bwd: dy {tuple(dy.shape)} != x "
                    f"{tuple(x.shape)}")
    w = weight if weight.dtype == torch.float32 else weight.float()
    dev = _launch.check_cuda("rms_norm_bwd", x, w, dy)
    code = _launch.dtype_code(x, "rms_norm_bwd")
    rows = x.numel() // max(d, 1)
    dx = torch.empty_like(x)
    part = torch.empty((max(1, -(-rows // _BWD_ROWS)), d),
                       dtype=torch.float32, device=dev)
    dw = torch.empty(d, dtype=torch.float32, device=dev)
    _launch.launch("ptt_rms_norm_bwd", x.data_ptr(), w.data_ptr(),
                   dy.data_ptr(), dx.data_ptr(), part.data_ptr(),
                   dw.data_ptr(), rows, d, float(epsilon), code,
                   _launch.stream_of(dev))
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
