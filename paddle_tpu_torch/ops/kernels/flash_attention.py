"""Flash attention: the forward kernel ``csrc/flash_attention.cu``, the
backward kernel ``csrc/flash_attention_bwd.cu`` and their plain twins.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``,
``_bwd`` with its dq and dk/dv kernels, the GQA group sum of
``_bwd_grouped`` and the ``flash_attention`` / ``flash_attention_with_lse``
wrappers); :class:`FlashAttentionFunction` joins forward and backward for
autograd, as the TPU package's ``custom_vjp`` does. Public layout is
Paddle's flash layout ``[batch, seq, heads, head_dim]``; GQA when
``heads(q)`` is a multiple of ``heads(k)``. The kernel reads that layout in
place, so the TPU wrapper's transposes and block padding have no
counterpart here: the kernel masks with the true lengths itself.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "FlashAttentionFunction",
           "launches", "launches_bwd"]

#: forward kernel launches made by the wrappers (never by the plain twin)
launches = 0
#: backward kernel launches made by :func:`flash_attention_bwd`
launches_bwd = 0

_HEAD_DIMS = (64, 128)


def flash_attention_plain(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor, is_causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math without tiling: fp32 scores from the inputs'
    exact products, ``col < sk`` and (causal) ``col <= row`` masks,
    probabilities rounded through V's dtype for the PV product while the
    row sum uses them unrounded, O = 0 and lse = -inf for a row with
    nothing visible. Returns ``(o [b, sq, hq, d], lse [b, hq, sq])``."""
    b, sq, hq, d = query.shape
    sk, hkv = key.shape[1], key.shape[2]
    group = hq // hkv
    q = query.float().transpose(1, 2)                        # b h sq d
    k = key.float().repeat_interleave(group, dim=2).transpose(1, 2)
    v = value.repeat_interleave(group, dim=2).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p.to(value.dtype).float(), v.float()) / l_safe
    lse = torch.where(m == float("-inf"), m, m + torch.log(l_safe))
    return o.to(query.dtype).transpose(1, 2), lse.squeeze(-1)


def flash_attention_with_lse(query: torch.Tensor, key: torch.Tensor,
                             value: torch.Tensor, is_causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention output in ``query``'s layout and dtype, plus the fp32
    log-sum-exp ``[b, hq, sq]``. CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    global launches
    if query.dim() != 4 or key.dim() != 4 or value.shape != key.shape:
        raise ValueError(f"flash_attention: expected q [b, sq, hq, d] and "
                         f"k/v [b, sk, hkv, d], got {tuple(query.shape)}, "
                         f"{tuple(key.shape)}, {tuple(value.shape)}")
    b, sq, hq, d = query.shape
    sk, hkv = key.shape[1], key.shape[2]
    if key.shape[0] != b or key.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_attention: incompatible q {tuple(query.shape)}"
                         f" and k {tuple(key.shape)} (GQA needs hq % hkv == 0)")
    if query.device.type == "cpu":
        return flash_attention_plain(query, key, value, is_causal)
    dev = _launch.check_cuda("flash_attention", query, key, value)
    code = _launch.dtype_code(query, "flash_attention")
    _launch.require(key.dtype == query.dtype and value.dtype == query.dtype,
                    "flash_attention: q, k and v must share a dtype")
    _launch.require(d in _HEAD_DIMS,
                    f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    o = torch.empty_like(query)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    _launch.launch("ptt_flash_attn_fwd", query.data_ptr(), key.data_ptr(),
                   value.data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq, sk,
                   hq, hkv, d, int(bool(is_causal)), 1.0 / math.sqrt(d),
                   code, _launch.stream_of(dev))
    launches += 1
    return o, lse


def flash_attention(query, key, value, is_causal: bool = False):
    """:func:`flash_attention_with_lse` without the log-sum-exp."""
    return flash_attention_with_lse(query, key, value, is_causal)[0]


def flash_attention_bwd_plain(query, key, value, out, lse, d_out,
                              is_causal: bool = False):
    """The TPU backward kernels' math without tiling: ``delta =
    rowsum(dO * O)`` and ``p = exp(s - lse)`` (an lse of -inf taken as
    0) in fp32, ``ds = p * (dp - delta) * scale``; ``ds`` is rounded to
    K's dtype before ``ds . K`` and to Q's dtype before ``ds^T . Q``, and
    ``p`` to dO's dtype before ``p^T . dO``. dK and dV are summed over
    each kv head's query heads in fp32. Returns ``(dq, dk, dv)`` in the
    inputs' layouts and dtypes."""
    b, sq, hq, d = query.shape
    sk, hkv = key.shape[1], key.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    q = query.float().transpose(1, 2)                        # b h sq d
    k = key.float().repeat_interleave(group, dim=2).transpose(1, 2)
    v = value.float().repeat_interleave(group, dim=2).transpose(1, 2)
    do = d_out.float().transpose(1, 2)
    delta = (do * out.float().transpose(1, 2)).sum(dim=-1, keepdim=True)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse_safe = torch.where(lse == float("-inf"), torch.zeros_like(lse),
                           lse).unsqueeze(-1)
    p = torch.exp(s - lse_safe)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds.to(key.dtype).float(), k)
    dk = torch.matmul(ds.to(query.dtype).float().transpose(-1, -2), q)
    dv = torch.matmul(p.to(d_out.dtype).float().transpose(-1, -2), do)

    def fold(x):  # [b, hq, sk, d] -> summed over the group -> [b, sk, hkv, d]
        return x.reshape(b, hkv, group, sk, d).sum(dim=2).transpose(1, 2)

    return (dq.transpose(1, 2).to(query.dtype), fold(dk).to(key.dtype),
            fold(dv).to(value.dtype))


def flash_attention_bwd(query, key, value, out, lse, d_out,
                        is_causal: bool = False):
    """``(dq, dk, dv)`` of :func:`flash_attention_with_lse` for the
    cotangent ``d_out`` of ``out``, given the forward's ``out`` and
    ``lse``. CPU tensors take the plain twin; CUDA tensors launch the
    kernel (delta, dq and dk/dv, one call); no atomics, so the gradients
    are the same bits on every run."""
    global launches_bwd
    d_out = d_out.to(out.dtype)
    if query.device.type == "cpu":
        return flash_attention_bwd_plain(query, key, value, out, lse, d_out,
                                         is_causal)
    b, sq, hq, d = query.shape
    sk, hkv = key.shape[1], key.shape[2]
    dev = _launch.check_cuda("flash_attention_bwd", query, key, value, out,
                             lse, d_out)
    code = _launch.dtype_code(query, "flash_attention_bwd")
    _launch.require(all(t.dtype == query.dtype
                        for t in (key, value, out, d_out)),
                    "flash_attention_bwd: q, k, v, o and dO must share a "
                    "dtype")
    _launch.require(lse.dtype == torch.float32 and lse.shape == (b, hq, sq),
                    f"flash_attention_bwd: lse must be fp32 [{b}, {hq}, "
                    f"{sq}], got {lse.dtype} {tuple(lse.shape)}")
    _launch.require(out.shape == query.shape and d_out.shape == query.shape
                    and value.shape == key.shape and hq % hkv == 0,
                    "flash_attention_bwd: shapes do not match the forward")
    _launch.require(d in _HEAD_DIMS,
                    f"flash_attention_bwd: head_dim {d} not in {_HEAD_DIMS}")
    dq = torch.empty_like(query)
    dk = torch.empty_like(key)
    dv = torch.empty_like(value)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    _launch.launch("ptt_flash_attn_bwd", query.data_ptr(), key.data_ptr(),
                   value.data_ptr(), out.data_ptr(), d_out.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d,
                   int(bool(is_causal)), 1.0 / math.sqrt(d), code,
                   _launch.stream_of(dev))
    launches_bwd += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention_with_lse` forward, keeping ``o`` and
    ``lse``; :func:`flash_attention_bwd` backward."""

    @staticmethod
    def forward(ctx, query, key, value, is_causal):
        query, key, value = (t.contiguous() for t in (query, key, value))
        o, lse = flash_attention_with_lse(query, key, value, is_causal)
        ctx.save_for_backward(query, key, value, o, lse)
        ctx.is_causal = is_causal
        return o

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                         d_out.contiguous(), ctx.is_causal)
        return dq, dk, dv, None
