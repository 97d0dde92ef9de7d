"""Fused decoder block: CUDA kernels ``csrc/fused_block.cu``, its plain
twin and its autograd Function.

Port of ``paddle_tpu/ops/pallas/fused_block.py``: causal GQA flash
attention, each head's output (rounded to the residual's dtype) folded
through its slice of Wo into an fp32 residual accumulator, RMSNorm with
an fp32 weight, then ``h += act . Wd`` over blocks of ffn with ``act =
(silu(hn . Wg -> T) * (hn . Wu -> T)) -> T``, one cast out
(``_fused_kernel``, ``fused_block.py:121-219``). q, k and v are cast to
the residual's dtype first (``_prep_all``).

Routes on CUDA, picked by :func:`route` from dtype, shape and alignment
before the launch (no route is a fallback on a failed launch, which
raises): bf16 with 16-byte-aligned bases at a head dim flash attention
takes (every multiple of 16 up to 256) runs the chain, five hand-written
launches (#1's attention, a ``wgmma`` o-projection into an fp32 residual,
#5's RMSNorm of it, a ``wgmma`` gate/up with the SwiGLU in its epilogue,
a ``wgmma`` down projection adding the residual) over scratch allocated
here; fp32, and bf16 on a base TMA cannot map, run the edge route, the
first port's single CUDA-core kernel, at head dims 64 and 128.

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
           "route", "smem_bytes", "launches"]

#: calls of :func:`fused_block` that launched its kernels (one a call: the
#: chain's five launches or the edge route's one; never by the plain twin)
launches = 0

#: head dims of the edge route's kernel (fp32, misaligned bf16)
_HEAD_DIMS = (64, 128)
# dynamic shared memory one block may use on Hopper (227 KB)
_SMEM_LIMIT = 232448
_GRID_LIMIT = 65535      # a CUDA grid's y axis: the chain's 128-row tiles
_ROWS = 128              # rows of a chain GEMM tile


def route(q_shape, hidden: int, ffn: int, dtype: torch.dtype,
          aligned: bool) -> str:
    """The CUDA route of a layer that passed :func:`ineligible_reason`'s
    structural checks: ``"chain"`` for bf16 at a head dim flash attention
    takes, with ``aligned`` (every base 16-byte aligned, for TMA) and the
    GEMMs' 128-row tiles within the grid; ``"edge"`` for fp32 and the rest
    of bf16 at head dim 64 or 128. Raises ValueError where neither takes
    the layer. Decided from dtype, shapes and alignment alone, before any
    launch."""
    b, s, _, d = q_shape
    if (dtype == torch.bfloat16 and aligned
            and d in _flash._HEAD_DIMS and hidden % 8 == 0 and ffn % 8 == 0
            and -(-b * s // _ROWS) <= _GRID_LIMIT):
        return "chain"
    if d in _HEAD_DIMS and dtype in _launch.DTYPE_CODE:
        return "edge"
    raise ValueError(
        f"fused_block: no CUDA route for {dtype} at head_dim {d} "
        f"({'16-byte-aligned' if aligned else 'misaligned'} bases): the "
        f"chain takes aligned bf16 at head dims 16..256 (multiples of 16), "
        f"the edge kernel head dims {_HEAD_DIMS}")


def ineligible_reason(q_shape, kv_shape, hidden: int, ffn: int,
                      dtype: torch.dtype,
                      device: torch.device) -> Optional[str]:
    """Why the fused block cannot run this layer, or None. The structural
    reasons are the reference's (``fused_block.ineligible_reason``). On a
    CUDA device: fp32 or bf16; bf16 (the chain) needs a head dim flash
    attention takes, any multiple of 16 up to 256; fp32 (the edge kernel)
    needs head_dim 64 or 128 and its shared memory (16 fp32 residual rows
    plus the attention or MLP working set) within one block's 227 KB,
    where the reference checked its VMEM budget. A bf16 call on a base TMA
    cannot map takes the edge kernel, with its limits (:func:`route`)."""
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
    if dtype not in _launch.DTYPE_CODE:
        return f"the CUDA kernels take float32 or bfloat16, got {dtype}"
    if dtype == torch.bfloat16:
        if d not in _flash._HEAD_DIMS:
            return (f"the bf16 chain takes the head dims of flash attention "
                    f"(multiples of 16 in 16..256), got head_dim {d}")
        return None
    if d not in _HEAD_DIMS:
        return f"the fp32 CUDA kernel takes head_dim {_HEAD_DIMS}, got {d}"
    need = smem_bytes(hidden, d, dtype)
    if need > _SMEM_LIMIT:
        return (f"shared memory {need} B exceeds {_SMEM_LIMIT} B per block "
                f"(hidden={hidden}, d={d}, {dtype})")
    return None


def smem_bytes(hidden: int, d: int, dtype: torch.dtype) -> int:
    """The edge kernel's dynamic shared memory for these widths, as the C
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
    CPU tensors take the plain twin; CUDA tensors launch the kernels of
    their route or raise (see :func:`ineligible_reason`, :func:`route`)."""
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
    bases = (q, k, v, resid, wn32, *ws, out)
    chain = route(q.shape, hidden, ffn, dt,
                  all(t.data_ptr() % 16 == 0 for t in bases)) == "chain"
    scratch, attn_tma = [None] * 5, False
    if chain:
        m = b * s
        scratch = [torch.empty_like(q),
                   torch.empty((b, nh, s), dtype=torch.float32, device=dev),
                   torch.empty((m, hidden), dtype=torch.float32, device=dev),
                   torch.empty((m, hidden), dtype=dt, device=dev),
                   torch.empty((m, ffn), dtype=dt, device=dev)]
        attn_tma = _flash._seg_fwd_tma_ok(b, nh, q, k, v)
    else:
        need = smem_bytes(hidden, d, dt)
        _launch.require(need <= _SMEM_LIMIT,
                        f"fused_block: the edge kernel needs {need} B of "
                        f"shared memory, over {_SMEM_LIMIT} B per block")
    _launch.launch("ptt_fused_block_fwd", *[t.data_ptr() for t in bases],
                   *[None if t is None else t.data_ptr() for t in scratch],
                   b, s, nh, nkv, d, hidden, ffn, 1.0 / math.sqrt(d),
                   float(eps), code, int(chain), int(attn_tma),
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
