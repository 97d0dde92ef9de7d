"""RMSNorm forward: CUDA kernel ``csrc/rms_norm.cu`` and its plain twin.

Port of ``paddle_tpu/ops/pallas/rms_norm.py`` (forward only; the fused
backward comes with the training slice). Same contract as the TPU
kernel: statistics in fp32 over the true width, ``y = x * r * w`` with an
fp32 weight, output in ``x``'s dtype.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["rms_norm", "rms_norm_plain", "launches"]

#: kernel launches made by :func:`rms_norm` (never by the plain twin)
launches = 0


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
