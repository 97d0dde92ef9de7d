"""Fused decoder block: CUDA kernel ``csrc/fused_block.cu``, its plain
twin and its autograd Function.

Port of ``paddle_tpu/ops/pallas/fused_block.py``: causal GQA flash
attention, each head's output (rounded to the residual's dtype) folded
through its slice of Wo into an fp32 residual accumulator, RMSNorm with
an fp32 weight, then ``h += act . Wd`` over blocks of ffn with ``act =
(silu(hn . Wg -> T) * (hn . Wu -> T)) -> T``, one cast out
(``_fused_kernel``, ``fused_block.py:121-219``). q, k and v are cast to
the residual's dtype first (``_prep_all``).

The backward, as in the reference (``fused_block_bwd``, ``:375-392``),
recomputes the composed block (``_composed``, ``:283-296``) from the
saved inputs through the flash-attention and RMSNorm Functions and
``torch.matmul``, and differentiates that.

Public layouts are the reference's: ``q [b, s, nh, d]``, ``k, v [b, s,
nkv, d]`` after RoPE, ``resid [b, s, hidden]``, ``wn [hidden]``, ``wo
[nh*d, hidden]``, ``wg, wu [hidden, ffn]``, ``wd [ffn, hidden]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.kernels import _build, _launch
from paddle_tpu_torch.ops.kernels import flash_attention as _flash
from paddle_tpu_torch.ops.kernels import rms_norm as _rms

__all__ = ["fused_block", "fused_block_plain",
           "fused_block_composed", "FusedBlockFunction", "ineligible_reason",
           "smem_bytes", "launches"]

#: kernel launches made by :func:`fused_block` (never by the plain twin)
launches = 0

_HEAD_DIMS = (64, 128)
# dynamic shared memory one block may use on Hopper (227 KB)
_SMEM_LIMIT = 232448


def ineligible_reason(q_shape, kv_shape, hidden: int, ffn: int,
                      dtype: torch.dtype,
                      device: torch.device) -> Optional[str]:
    """Why the fused block cannot run this layer, or None. The structural
    reasons are the reference's (``fused_block.ineligible_reason``); on a
    CUDA device the kernel also needs head_dim 64 or 128, fp32 or bf16,
    and its shared memory (16 fp32 residual rows plus the attention or
    MLP working set) within one block's 227 KB, where the reference
    checked its VMEM budget."""
    b, s, nh, d = q_shape
    nkv = kv_shape[2]
    if not dtype.is_floating_point:
        return f"non-floating dtype {dtype}"
    if nh % nkv:
        return f"GQA needs heads % kv_heads == 0, got {nh} % {nkv}"
    if nh * d != hidden:
        return (f"o_proj input dim {nh * d} != hidden {hidden} "
                f"(non-square attention output unsupported)")
    if d % 8 or hidden % 8 or ffn % 8:
        return (f"head_dim/hidden/ffn must be multiples of 8, got "
                f"d={d}, hidden={hidden}, ffn={ffn}")
    if torch.device(device).type != "cuda":
        return None
    if d not in _HEAD_DIMS:
        return f"the CUDA kernel takes head_dim {_HEAD_DIMS}, got {d}"
    if dtype not in _launch.DTYPE_CODE:
        return f"the CUDA kernel takes float32 or bfloat16, got {dtype}"
    need = smem_bytes(hidden, d, dtype)
    if need > _SMEM_LIMIT:
        return (f"shared memory {need} B exceeds {_SMEM_LIMIT} B per block "
                f"(hidden={hidden}, d={d}, {dtype})")
    return None


def smem_bytes(hidden: int, d: int, dtype: torch.dtype) -> int:
    """The kernel's dynamic shared memory for these widths, as the C
    side lays it out (``layout`` in ``fused_block.cu``)."""
    lib = _build.library()
    return int(lib.ptt_fused_block_smem_bytes(hidden, d,
                                              _launch.DTYPE_CODE[dtype]))


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded through ``dtype``, kept in fp32."""
    return x.to(dtype).float()


def fused_block_plain(q, k, v, resid, wn, wo, wg, wu, wd,
                      eps: float = 1e-6) -> torch.Tensor:
    """The kernel's math without tiling, with its rounding points: the
    attention output rounded to T, the residual and both products into it
    in fp32, hn rounded to T, g, u, silu(g) and act each rounded to T,
    one cast out."""
    dt = resid.dtype
    b, s, nh, d = q.shape
    q, k, v = (t.to(dt) for t in (q, k, v))
    o, _ = _flash.flash_attention_plain(q, k, v, True)
    h = resid.float() + torch.matmul(o.reshape(b, s, nh * d).float(),
                                     wo.float())
    ms = (h * h).sum(dim=-1, keepdim=True) / h.shape[-1]
    hn = (h * torch.rsqrt(ms + eps) * wn.float()).to(dt).float()
    g = _rounded(torch.matmul(hn, wg.float()), dt)
    u = _rounded(torch.matmul(hn, wu.float()), dt)
    act = _rounded(_rounded(F.silu(g), dt) * u, dt)
    return (h + torch.matmul(act, wd.float())).to(dt)


def fused_block_composed(q, k, v, resid, wn, wo, wg, wu, wd,
                         eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``_composed``: flash attention and RMSNorm through
    their autograd Functions, the rest ``torch.matmul``; differentiable,
    and what the fused block's backward differentiates."""
    b, s, nh, d = q.shape
    attn = _flash.FlashAttentionFunction.apply(q, k, v, True)
    h = resid + torch.matmul(attn.reshape(b, s, nh * d), wo)
    hn = _rms.RMSNormFunction.apply(h, wn, eps)
    g = torch.matmul(hn, wg)
    u = torch.matmul(hn, wu)
    return h + torch.matmul((F.silu(g) * u).to(hn.dtype), wd)


def fused_block(q, k, v, resid, wn, wo, wg, wu, wd,
                eps: float = 1e-6) -> torch.Tensor:
    """The fused block's forward, ``[b, s, hidden]`` in resid's dtype.
    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise (see :func:`ineligible_reason`)."""
    global launches
    dt = resid.dtype
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    if resid.device.type == "cpu":
        return fused_block_plain(q, k, v, resid, wn, wo, wg, wu, wd, eps)
    b, s, nh, d = q.shape
    nkv, hidden, ffn = k.shape[2], resid.shape[-1], wg.shape[-1]
    reason = ineligible_reason(q.shape, k.shape, hidden, ffn, dt,
                               resid.device)
    if reason is not None:
        raise ValueError(f"fused_block: {reason}")
    _launch.require(
        k.shape == v.shape == (b, s, nkv, d) and resid.shape == (b, s, hidden)
        and wn.shape == (hidden,) and wo.shape == (nh * d, hidden)
        and wg.shape == wu.shape == (hidden, ffn)
        and wd.shape == (ffn, hidden),
        f"fused_block: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
        f"resid {tuple(resid.shape)}, wo {tuple(wo.shape)}, wg "
        f"{tuple(wg.shape)}, wd {tuple(wd.shape)} do not fit together")
    wn32 = wn.float().contiguous()
    ws = [w.contiguous() for w in (wo, wg, wu, wd)]
    dev = _launch.check_cuda("fused_block", q, k, v, resid, wn32, *ws)
    code = _launch.dtype_code(resid, "fused_block")
    _launch.require(all(w.dtype == dt for w in ws),
                    "fused_block: weights must share the residual's dtype")
    out = torch.empty_like(resid)
    _launch.launch("ptt_fused_block_fwd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), resid.data_ptr(), wn32.data_ptr(),
                   *[w.data_ptr() for w in ws], out.data_ptr(), b, s, nh,
                   nkv, d, hidden, ffn, 1.0 / math.sqrt(d), float(eps), code,
                   _launch.stream_of(dev))
    launches += 1
    return out


class FusedBlockFunction(torch.autograd.Function):
    """:func:`fused_block` forward; the backward recomputes
    :func:`fused_block_composed` from the saved inputs and differentiates
    it (``fused_block_bwd`` of the reference). Inputs are already in the
    residual's dtype."""

    @staticmethod
    def forward(ctx, eps, q, k, v, resid, wn, wo, wg, wu, wd):
        ctx.save_for_backward(q, k, v, resid, wn, wo, wg, wu, wd)
        ctx.eps = eps
        return fused_block(q, k, v, resid, wn, wo, wg, wu, wd, eps)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[1:])]
            out = fused_block_composed(*inputs, eps=ctx.eps)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, dy))
        return (None,) + tuple(next(grads) if t.requires_grad else None
                               for t in inputs)
