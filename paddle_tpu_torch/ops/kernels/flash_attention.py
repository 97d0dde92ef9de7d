"""Flash-attention forward: CUDA kernel ``csrc/flash_attention.cu`` and
its plain twin.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` forward
(``_fwd_kernel`` and the ``flash_attention`` / ``flash_attention_with_lse``
wrappers; the backward comes with the training slice). Public layout is
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
           "flash_attention_plain", "launches"]

#: kernel launches made by the wrappers (never by the plain twin)
launches = 0

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
