"""Flash attention: the forward kernel ``csrc/flash_attention.cu``, the
backward kernel ``csrc/flash_attention_bwd.cu``, the segment-causal pair
``csrc/flash_attention_seg.cu`` and their plain twins.

Port of ``paddle_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``,
``_bwd`` with its dq and dk/dv kernels, the GQA group sum of
``_bwd_grouped`` and the ``flash_attention`` / ``flash_attention_with_lse``
wrappers; the segment-causal ``_fwd_seg`` / ``_bwd_grouped_seg`` behind
``flash_attention_seg_with_lse``, which the zig-zag ring calls);
:class:`FlashAttentionFunction` joins forward and backward for autograd,
as the TPU package's ``custom_vjp`` does. Public layout is
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
           "flash_attention_seg_with_lse", "flash_attention_seg_plain",
           "flash_attention_seg_bwd", "flash_attention_seg_bwd_plain",
           "seg_positions", "launches", "launches_bwd", "launches_seg",
           "launches_seg_bwd"]

#: forward kernel launches made by the wrappers (never by the plain twin)
launches = 0
#: backward kernel launches made by :func:`flash_attention_bwd`
launches_bwd = 0
#: segment-causal forward launches (:func:`flash_attention_seg_with_lse`)
launches_seg = 0
#: segment-causal backward launches (:func:`flash_attention_seg_bwd`)
launches_seg_bwd = 0

_HEAD_DIMS = (64, 128)


def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """``col <= row`` (top-left aligned) as a bool ``[sq, sk]`` mask."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril()


def _attention_plain(query, key, value, keep):
    """The forward kernels' math without tiling, under the bool mask
    ``keep [sq, sk]`` (None: every column visible). Returns ``(o, lse)``."""
    b, sq, hq, d = query.shape
    hkv = key.shape[2]
    group = hq // hkv
    q = query.float().transpose(1, 2)                        # b h sq d
    k = key.float().repeat_interleave(group, dim=2).transpose(1, 2)
    v = value.repeat_interleave(group, dim=2).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p.to(value.dtype).float(), v.float()) / l_safe
    lse = torch.where(m == float("-inf"), m, m + torch.log(l_safe))
    return o.to(query.dtype).transpose(1, 2), lse.squeeze(-1)


def flash_attention_plain(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor, is_causal: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math without tiling: fp32 scores from the inputs'
    exact products, ``col < sk`` and (causal) ``col <= row`` masks,
    probabilities rounded through V's dtype for the PV product while the
    row sum uses them unrounded, O = 0 and lse = -inf for a row with
    nothing visible. Returns ``(o [b, sq, hq, d], lse [b, hq, sq])``."""
    keep = (_causal_keep(query.shape[1], key.shape[1], query.device)
            if is_causal else None)
    return _attention_plain(query, key, value, keep)


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
    if query.dtype == torch.bfloat16:   # the tensor maps' base addresses
        _launch.require(all(t.data_ptr() % 16 == 0
                            for t in (query, key, value)),
                        "flash_attention: bf16 q, k and v must start at "
                        "16-byte aligned addresses (TMA)")
        _launch.require(b * hq <= 65535 and -(-sq // 128) <= 65535,
                        f"flash_attention: bf16 batch x heads {b * hq} or "
                        f"query tiles {-(-sq // 128)} exceed the grid's "
                        f"65535")
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


def _attention_bwd_plain(query, key, value, out, lse, d_out, keep):
    """The backward kernels' math without tiling under the bool mask
    ``keep [sq, sk]`` (None: every column visible)."""
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
    if keep is not None:
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


def flash_attention_bwd_plain(query, key, value, out, lse, d_out,
                              is_causal: bool = False):
    """The TPU backward kernels' math without tiling: ``delta =
    rowsum(dO * O)`` and ``p = exp(s - lse)`` (an lse of -inf taken as
    0) in fp32, ``ds = p * (dp - delta) * scale``; ``ds`` is rounded to
    K's dtype before ``ds . K`` and to Q's dtype before ``ds^T . Q``, and
    ``p`` to dO's dtype before ``p^T . dO``. dK and dV are summed over
    each kv head's query heads in fp32. Returns ``(dq, dk, dv)`` in the
    inputs' layouts and dtypes."""
    keep = (_causal_keep(query.shape[1], key.shape[1], query.device)
            if is_causal else None)
    return _attention_bwd_plain(query, key, value, out, lse, d_out, keep)


def flash_attention_bwd(query, key, value, out, lse, d_out,
                        is_causal: bool = False):
    """``(dq, dk, dv)`` of :func:`flash_attention_with_lse` for the
    cotangent ``d_out`` of ``out``, given the forward's ``out`` and
    ``lse``. CPU tensors take the plain twin; CUDA tensors launch the
    kernel (bf16: dq with delta, then dk/dv, on the tensor cores; fp32:
    delta, dq and dk/dv on the CUDA cores; one call); no atomics, so the
    gradients are the same bits on every run."""
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
    if query.dtype == torch.bfloat16:   # the tensor maps and O's 16-byte loads
        _launch.require(all(t.data_ptr() % 16 == 0
                            for t in (query, key, value, out, d_out)),
                        "flash_attention_bwd: bf16 q, k, v, o and dO must "
                        "start at 16-byte aligned addresses (TMA)")
        _launch.require(b * hq <= 65535 and b * hkv <= 65535,
                        f"flash_attention_bwd: bf16 batch x heads {b * hq} "
                        f"exceeds the grid's 65535")
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


# ----------------------------------------- segment-causal (zig-zag ring)
# The zig-zag ring hands each call a LOCAL q/k window made of two chunks at
# arbitrary GLOBAL positions, described by six ints
#   seg = [q_off0, q_off1, q_split, k_off0, k_off1, k_split]:
# local row i sits at `i < split ? off0 + i : off1 + (i - split)` (columns
# the same), and the mask is g(row) >= g(col). Contract: off1 >= off0 +
# split, so both maps are monotone and the kernels' dead-tile skips are
# exact (``paddle_tpu/ops/pallas/flash_attention.py:377-391``).

def _check_seg(seg, sq: int, sk: int, what: str) -> Tuple[int, ...]:
    seg = tuple(int(x) for x in seg)
    if len(seg) != 6:
        raise ValueError(f"{what}: seg must be six ints [q_off0, q_off1, "
                         f"q_split, k_off0, k_off1, k_split], got {seg}")
    for (off0, off1, split), n, side in ((seg[:3], sq, "q"),
                                         (seg[3:], sk, "k")):
        if not (0 <= split <= n and off0 >= 0 and off1 >= off0 + split):
            raise ValueError(
                f"{what}: {side} map ({off0}, {off1}, split {split}) over "
                f"{n} rows is not monotone (needs 0 <= split <= {n}, "
                f"off0 >= 0 and off1 >= off0 + split)")
    return seg


def seg_positions(off0: int, off1: int, split: int, n: int,
                  device=None) -> torch.Tensor:
    """Global positions of ``n`` local rows under one half of a segment
    descriptor (``_seg_pos``, ``flash_attention.py:390``)."""
    i = torch.arange(n, device=device)
    return torch.where(i < split, off0 + i, off1 + (i - split))


def _seg_keep(seg, sq: int, sk: int, device) -> torch.Tensor:
    gq = seg_positions(*seg[:3], sq, device)
    gk = seg_positions(*seg[3:], sk, device)
    return gq[:, None] >= gk[None, :]


def flash_attention_seg_plain(query, key, value, seg):
    """The segment-causal forward without tiling: #1's twin under the
    mask ``g_q(row) >= g_k(col)``, with its rounding rules. Returns
    ``(o [b, sq, hq, d], lse [b, hq, sq])``."""
    seg = _check_seg(seg, query.shape[1], key.shape[1],
                     "flash_attention_seg")
    return _attention_plain(query, key, value,
                            _seg_keep(seg, query.shape[1], key.shape[1],
                                      query.device))


def flash_attention_seg_bwd_plain(query, key, value, out, lse, d_out, seg):
    """The segment-causal backward without tiling: #2's twin under the
    segment mask. Returns ``(dq, dk, dv)``: dq in Q's dtype, dk and dv
    summed over the GQA group in fp32 and returned in K's dtype."""
    seg = _check_seg(seg, query.shape[1], key.shape[1],
                     "flash_attention_seg_bwd")
    return _attention_bwd_plain(query, key, value, out, lse, d_out,
                                _seg_keep(seg, query.shape[1], key.shape[1],
                                          query.device))


def _check_shapes(what, query, key, value):
    if query.dim() != 4 or key.dim() != 4 or value.shape != key.shape:
        raise ValueError(f"{what}: expected q [b, sq, hq, d] and k/v "
                         f"[b, sk, hkv, d], got {tuple(query.shape)}, "
                         f"{tuple(key.shape)}, {tuple(value.shape)}")
    b, _, hq, d = query.shape
    if key.shape[0] != b or key.shape[3] != d or hq % key.shape[2]:
        raise ValueError(f"{what}: incompatible q {tuple(query.shape)} and "
                         f"k {tuple(key.shape)} (GQA needs hq % hkv == 0)")


def flash_attention_seg_with_lse(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor, seg
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-causal attention (#3): the output in ``query``'s layout and
    dtype and the fp32 log-sum-exp ``[b, hq, sq]``, under the mask of the
    six-int descriptor ``seg``. CPU tensors take the plain twin; CUDA
    tensors launch ``ptt_flash_attn_fwd_seg``. The zig-zag ring owns the
    backward (:func:`flash_attention_seg_bwd` with the merged lse)."""
    global launches_seg
    _check_shapes("flash_attention_seg", query, key, value)
    if query.device.type == "cpu":
        return flash_attention_seg_plain(query, key, value, seg)
    b, sq, hq, d = query.shape
    sk, hkv = key.shape[1], key.shape[2]
    seg = _check_seg(seg, sq, sk, "flash_attention_seg")
    dev = _launch.check_cuda("flash_attention_seg", query, key, value)
    code = _launch.dtype_code(query, "flash_attention_seg")
    _launch.require(key.dtype == query.dtype and value.dtype == query.dtype,
                    "flash_attention_seg: q, k and v must share a dtype")
    _launch.require(d in _HEAD_DIMS,
                    f"flash_attention_seg: head_dim {d} not in {_HEAD_DIMS}")
    o = torch.empty_like(query)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    _launch.launch("ptt_flash_attn_fwd_seg", query.data_ptr(),
                   key.data_ptr(), value.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), b, sq, sk, hq, hkv, d, *seg,
                   1.0 / math.sqrt(d), code, _launch.stream_of(dev))
    launches_seg += 1
    return o, lse


def flash_attention_seg_bwd(query, key, value, out, lse, d_out, seg):
    """``(dq, dk, dv)`` of segment-causal attention (#4) for the
    cotangent ``d_out``, given ``out`` and ``lse`` (the ring passes the
    MERGED ones of its rows). dq in Q's dtype; dk and dv summed over the
    GQA group in fp32 and returned in K's dtype. CPU tensors take the
    plain twin; CUDA tensors launch ``ptt_flash_attn_bwd_seg`` (no
    atomics: the same bits on every run)."""
    global launches_seg_bwd
    d_out = d_out.to(out.dtype)
    if query.device.type == "cpu":
        return flash_attention_seg_bwd_plain(query, key, value, out, lse,
                                             d_out, seg)
    _check_shapes("flash_attention_seg_bwd", query, key, value)
    b, sq, hq, d = query.shape
    sk, hkv = key.shape[1], key.shape[2]
    seg = _check_seg(seg, sq, sk, "flash_attention_seg_bwd")
    dev = _launch.check_cuda("flash_attention_seg_bwd", query, key, value,
                             out, lse, d_out)
    code = _launch.dtype_code(query, "flash_attention_seg_bwd")
    _launch.require(all(t.dtype == query.dtype
                        for t in (key, value, out, d_out)),
                    "flash_attention_seg_bwd: q, k, v, o and dO must share "
                    "a dtype")
    _launch.require(lse.dtype == torch.float32 and lse.shape == (b, hq, sq),
                    f"flash_attention_seg_bwd: lse must be fp32 [{b}, {hq}, "
                    f"{sq}], got {lse.dtype} {tuple(lse.shape)}")
    _launch.require(out.shape == query.shape and d_out.shape == query.shape,
                    "flash_attention_seg_bwd: o and dO must have q's shape")
    _launch.require(d in _HEAD_DIMS,
                    f"flash_attention_seg_bwd: head_dim {d} not in "
                    f"{_HEAD_DIMS}")
    dq = torch.empty_like(query)
    dk = torch.empty_like(key)
    dv = torch.empty_like(value)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    _launch.launch("ptt_flash_attn_bwd_seg", query.data_ptr(),
                   key.data_ptr(), value.data_ptr(), out.data_ptr(),
                   d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq,
                   hkv, d, *seg, 1.0 / math.sqrt(d), code,
                   _launch.stream_of(dev))
    launches_seg_bwd += 1
    return dq, dk, dv
