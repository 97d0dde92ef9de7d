"""Chunked SSD selective scan: CUDA kernel ``csrc/selective_scan.cu``, its
chunked plain twin, the associative-scan plain path and the O(1) decode
recurrence.

Port of ``paddle_tpu/ops/pallas/selective_scan.py``. The recurrence
``S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t``, ``y_t = C_t S_t`` runs in
its chunked dual form: inside a chunk of ``L`` positions the output is a
masked ``L x L`` decay matrix times ``dt x``, and only one fp32 ``[d_state,
head_dim]`` state is carried from chunk to chunk (:func:`_chunk_math`).

The ``pallas_selective_scan`` flag keeps the reference's name: ``auto``
(and its alias ``on``) take the chunked form — the kernel for CUDA tensors,
the chunked twin :func:`_scan_reference` for CPU tensors. ``off`` takes the
associative-scan path :func:`xla_selective_scan` (which materializes every
position's state) on CPU tensors only; on CUDA tensors it raises, since
that path has no kernel. On CUDA a shape the kernel cannot take raises with
its reason, and so does a call that needs gradients: the scan's backward
(the reference's ``jax.vjp`` of the chunked form) comes with hybrid
training (ROADMAP.md A.9). On the CPU the twin stays differentiable.

Single-token decode never scans: :func:`selective_scan_update` is the
recurrence's one step, plain torch as in the reference.
"""

from __future__ import annotations

import functools

from typing import Optional, Tuple

import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["selective_scan", "scan_chunked", "xla_selective_scan",
           "selective_scan_update", "ineligible_reason", "resolve_chunk",
           "launch_plan", "launches"]

#: kernel launches made by :func:`scan_chunked` (never by the twins)
launches = 0

_MIN_CHUNK = 16           # a chunk is whole 16-row tensor-core tiles
_MAX_CHUNK = 256
_MIN_BLOCKS = 2 * 132     # two blocks an SM (``kMinBlocks``)
_SMEM_LIMIT = 232448      # dynamic shared memory one block may use on H100


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def resolve_chunk(l: int) -> int:
    """The static chunk of ``autotune.py:505-509``: 128, or 256 from 2048
    positions on, never above the length's power-of-two bucket nor below
    16. (The reference's measured sweep is not ported.) The chunk sets
    where bf16 rounding happens, so kernel and twin take the same one."""
    return min(256 if l >= 2048 else 128, max(16, _bucket(l)))


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def head_groups(h: int, base: int) -> int:
    """How many groups a launch splits the ``h`` heads into (``head_groups``
    in the .cu): the fewest, a divisor of ``h``, that give ``base`` x
    groups >= two blocks an SM, else ``h``."""
    for g in range(1, h + 1):
        if h % g == 0 and base * g >= _MIN_BLOCKS:
            return g
    return h


def _row_tile(L: int) -> int:
    """Rows of y an fp32 chunk_out block takes (``row_tile``)."""
    return min(L, 64)


def _state_smem(L: int, dh: int, ds: int, hg: int, esize: int) -> int:
    """``scan_chunk_state``'s dynamic shared memory (``state_smem_f32`` /
    ``state_smem_bf16``): fp32 keeps B, B o exp(cs_L - cs) and dtx as
    fp32; bf16 keeps B and dtx as bf16; both the heads' cs rows and the
    decays to the chunk's end."""
    if esize == 4:
        return (_align16(L * (ds + 1) * 4) + _align16(L * ds * 4)
                + _align16(L * dh * 4) + _align16(hg * L * 4)
                + _align16(L * 4))
    return (_align16(L * (_round16(ds) + 8) * 2) + _align16(hg * L * 4)
            + _align16(L * 4) + _align16(L * (dh + 8) * 2))


def _out_smem(L: int, dh: int, ds: int, esize: int) -> int:
    """``scan_chunk_out``'s (``out_smem_f32`` / ``out_smem_bf16``): fp32
    keeps B, C^T and (C o exp(cs_t))^T, G^T and M^T of its row tile, dtx
    and S_prev as fp32; bf16 (a block a head and chunk) keeps B and dtx as
    bf16, S_prev as fp32 and the chunk's cs."""
    if esize == 4:
        R = _row_tile(L)
        return (_align16(L * (ds + 1) * 4) + 2 * _align16(ds * R * 4)
                + 2 * _align16(L * R * 4) + _align16(L * dh * 4)
                + _align16(ds * dh * 4) + _align16(L * 4) + _align16(R * 4))
    d16 = _round16(ds)
    return (_align16(L * (d16 + 8) * 2) + _align16(L * (dh + 8) * 2)
            + _align16(d16 * (dh + 4) * 4) + _align16(L * 4))


def launch_plan(bsz: int, lp: int, h: int, dh: int, ds: int, L: int,
                esize: int) -> dict:
    """The three launches of a call (``ptt_selective_scan`` in the .cu):
    grids (x, y, z), threads, heads a block and dynamic shared memory of
    ``scan_chunk_state`` and ``scan_chunk_out``, and the state pass's
    grid. fp32's chunk_out takes 64-row tiles of a chunk for a group of
    heads (G shared by them); bf16's a whole chunk of one head."""
    nc = lp // L
    g1 = head_groups(h, nc * bsz)
    if esize == 4:
        rt = -(-L // _row_tile(L))
        g3 = head_groups(h, nc * bsz * rt)
        out = dict(grid=(rt, nc, bsz * g3), threads=256, heads=h // g3,
                   smem=_out_smem(L, dh, ds, esize))
    else:
        out = dict(grid=(nc, bsz, h), threads=256, heads=1,
                   smem=_out_smem(L, dh, ds, esize))
    return dict(state=dict(grid=(nc, bsz, g1), threads=256, heads=h // g1,
                           smem=_state_smem(L, dh, ds, h // g1, esize)),
                passes=dict(grid=(-(-bsz * h * ds * dh // 256), 1, 1),
                            threads=256),
                out=out)


def ineligible_reason(x_shape, d_state: int, chunk: int,
                      dtype) -> Optional[str]:
    """Why the kernel cannot take this shape, or None (the reference's
    check, with the port's shared-memory limit in place of the VMEM
    budget)."""
    return _ineligible(tuple(x_shape), int(d_state), int(chunk), dtype)


@functools.lru_cache(maxsize=256)
def _ineligible(x_shape, d_state: int, chunk: int, dtype) -> Optional[str]:
    bsz, l, h, dh = x_shape
    if dtype not in (torch.float32, torch.bfloat16):
        return f"dtype {dtype} (the kernel takes float32 or bfloat16)"
    if dh % 8 or d_state % 8:
        return (f"head_dim/d_state must be multiples of 8, got dh={dh}, "
                f"d_state={d_state}")
    if dtype == torch.bfloat16 and (dh > 128 or d_state > 128):
        return (f"head_dim {dh} or d_state {d_state} > 128 (the bf16 "
                f"tensor-core tiles)")
    if l < 1:
        return f"empty sequence (l={l})"
    if chunk < _MIN_CHUNK or chunk > _MAX_CHUNK or chunk % _MIN_CHUNK:
        return (f"chunk {chunk} must be a multiple of {_MIN_CHUNK} in "
                f"[{_MIN_CHUNK}, {_MAX_CHUNK}]")
    esize = 4 if dtype == torch.float32 else 2
    lp = -(-l // chunk) * chunk
    plan = launch_plan(max(bsz, 1), lp, max(h, 1), dh, d_state, chunk, esize)
    smem = max(plan["state"]["smem"], plan["out"]["smem"])
    if smem > _SMEM_LIMIT:
        return (f"shared memory {smem} B exceeds {_SMEM_LIMIT} B at "
                f"chunk={chunk} (dh={dh}, d_state={d_state})")
    return None


# ------------------------------------------------------------ chunk math
def _chunk_math(dtx_c, la_c, b_c, c_c, s_prev):
    """One chunk of the dual form for every (batch, head) at once
    (``selective_scan.py:117-150``): ``dtx_c [b, h, L, dh]`` in the input
    dtype, ``la_c [b, h, L]`` fp32 log-decays, ``b_c/c_c [b, L, ds]``,
    ``s_prev [b, h, ds, dh]`` fp32. Returns ``(y [b, h, L, dh] fp32,
    s_new)``."""
    L = dtx_c.shape[-2]
    cs = torch.cumsum(la_c, dim=-1)                             # b h L
    g = torch.matmul(c_c.float(), b_c.float().transpose(-1, -2))  # b L L
    diff = cs[..., :, None] - cs[..., None, :]
    causal = torch.ones(L, L, dtype=torch.bool, device=cs.device).tril()
    # exp(-inf) = 0 on the masked half: no positive exponent is evaluated
    m = g[:, None] * torch.exp(diff.masked_fill(~causal, float("-inf")))
    xf = dtx_c.float()
    y = torch.matmul(m.to(dtx_c.dtype).float(), xf)
    c_in = c_c.float()[:, None] * torch.exp(cs)[..., None]      # b h L ds
    y = y + torch.matmul(c_in, s_prev)
    total = cs[..., -1:]
    b_in = b_c.float()[:, None] * torch.exp(total - cs)[..., None]
    s_new = (torch.exp(total)[..., None] * s_prev
             + torch.matmul(b_in.transpose(-1, -2), xf))
    return y, s_new


def _scan_reference(dtx, la_t, B, C, chunk: int):
    """The kernel's plain twin: :func:`_chunk_math` driven by a loop over
    the chunks. ``dtx [b, lp, h, dh]``, ``la_t [b, h, lp]`` fp32, ``B/C
    [b, lp, ds]``, ``lp`` a multiple of ``chunk``. Returns ``(y [b, lp, h,
    dh]`` in dtx's dtype, ``state [b, h, ds, dh]`` fp32)."""
    bsz, lp, h, dh = dtx.shape
    ds = B.shape[-1]
    s = torch.zeros(bsz, h, ds, dh, dtype=torch.float32, device=dtx.device)
    ys = []
    for c0 in range(0, lp, chunk):
        sl = slice(c0, c0 + chunk)
        y, s = _chunk_math(dtx[:, sl].transpose(1, 2), la_t[..., sl],
                           B[:, sl], C[:, sl], s)
        ys.append(y.to(dtx.dtype))
    return torch.cat(ys, dim=2).transpose(1, 2), s


def scan_chunked(dtx, la_t, B, C, chunk: int):
    """The chunked scan over padded inputs (see :func:`_scan_reference`).
    CPU tensors take the twin; CUDA tensors launch the kernel, or raise for
    a shape it cannot take."""
    global launches
    if dtx.device.type == "cpu":
        return _scan_reference(dtx, la_t, B, C, chunk)
    dev = _launch.check_cuda("selective_scan", dtx, la_t, B, C)
    bsz, lp, h, dh = dtx.shape
    ds = B.shape[-1]
    reason = ineligible_reason(dtx.shape, ds, chunk, dtx.dtype)
    if reason is not None:
        raise ValueError(f"selective_scan: {reason}")
    if not (lp % chunk == 0 and la_t.shape == (bsz, h, lp)
            and la_t.dtype == torch.float32
            and B.shape == (bsz, lp, ds) and C.shape == B.shape):
        raise ValueError(f"selective_scan: dtx {tuple(dtx.shape)}, la_t "
                         f"{tuple(la_t.shape)} {la_t.dtype}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} at chunk "
                         f"{chunk}")
    if B.dtype != dtx.dtype or C.dtype != dtx.dtype:
        raise ValueError(f"selective_scan: B/C {B.dtype}/{C.dtype} must have "
                         f"x's dtype {dtx.dtype}")
    y = torch.empty_like(dtx)
    state = torch.empty(bsz, h, ds, dh, dtype=torch.float32, device=dev)
    # scratch, one allocation: each chunk's cumulative log-decays, then
    # each chunk's state contribution (overwritten by the state entering
    # the chunk); the second starts 4 * n_cs bytes in, 64-byte aligned
    n_cs = bsz * h * lp
    scratch = torch.empty(n_cs + (lp // chunk) * bsz * h * ds * dh,
                          dtype=torch.float32, device=dev)
    _launch.launch("ptt_selective_scan", dtx.data_ptr(), la_t.data_ptr(),
                   B.data_ptr(), C.data_ptr(), y.data_ptr(),
                   state.data_ptr(), scratch.data_ptr(),
                   scratch.data_ptr() + 4 * n_cs, bsz, lp, h, dh, ds,
                   int(chunk), _launch.DTYPE_CODE[dtx.dtype],
                   _launch.stream_of(dev))
    launches += 1
    return y, state


# ------------------------------------------------------------- dispatch
def _chunked_wanted(device) -> bool:
    mode = str(flags.flag("pallas_selective_scan")).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"pallas_selective_scan must be 'auto', 'on' or "
                         f"'off', got {mode!r}")
    if mode == "off" and device.type != "cpu":
        raise NotImplementedError(
            "pallas_selective_scan=off: the associative scan has no kernel; "
            "a scan of CUDA tensors takes the chunked kernel (auto/on)")
    return mode != "off"


def selective_scan(x, dt, A, B, C, chunk: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD selective scan: ``(y, final_state)``.

    ``x [b, l, h, dh]``; ``dt [b, l, h]`` positive step sizes
    (post-softplus); ``A [h]`` negative decay rates; ``B/C [b, l, d_state]``
    (one state group shared by the heads). Returns ``y [b, l, h, dh]`` in
    x's dtype and the final state ``[b, h, d_state, dh]`` fp32, the state
    the decode recurrence continues from. ``chunk`` defaults to
    :func:`resolve_chunk`.
    """
    bsz, l, h, dh = x.shape
    dtf = dt.float()
    la = dtf * A.float()                                        # b l h
    dtx = (dtf[..., None] * x.float()).to(x.dtype)
    if not _chunked_wanted(x.device):
        return _xla_scan_core(dtx, la, B, C)
    if x.device.type != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "selective_scan: the scan's backward on CUDA comes with hybrid "
            "training (ROADMAP.md A.9); run the scan under torch.no_grad()")
    L = int(chunk if chunk is not None else resolve_chunk(l))
    lp = -(-l // L) * L
    if lp != l:
        # zero dt*x, B and C and zero log-decay (decay 1) in the padded
        # tail: the carry passes through untouched, y's tail is dropped
        pad = lp - l
        dtx = torch.nn.functional.pad(dtx, (0, 0, 0, 0, 0, pad))
        la = torch.nn.functional.pad(la, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    la_t = la.transpose(1, 2).contiguous()                      # b h lp
    y, s = scan_chunked(dtx.contiguous(), la_t, B.contiguous(),
                        C.contiguous(), L)
    return y[:, :l], s


def _xla_scan_core(dtx, la, B, C):
    """The associative-scan path (``selective_scan.py:335-353``): an
    inclusive scan of ``(decay, state)`` pairs under ``(a1, s1) . (a2, s2)
    = (a1 a2, a2 s1 + s2)``, in log2(l) doubling steps, over the full
    ``[b, l, h, ds, dh]`` fp32 state sequence."""
    a = torch.exp(la)                                           # b l h
    s = torch.einsum("bln,blhd->blhnd", B.float(), dtx.float())
    l, off = a.shape[1], 1
    while off < l:
        s = torch.cat([s[:, :off],
                       a[:, off:, :, None, None] * s[:, :-off] + s[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    y = torch.einsum("bln,blhnd->blhd", C.float(), s)
    return y.to(dtx.dtype), s[:, -1]


def xla_selective_scan(x, dt, A, B, C):
    """The associative-scan path whatever the flag says (tests)."""
    dtf = dt.float()
    la = dtf * A.float()
    dtx = (dtf[..., None] * x.float()).to(x.dtype)
    return _xla_scan_core(dtx, la, B, C)


# ------------------------------------------------------ decode recurrence
def selective_scan_update(state, x_t, dt_t, A, B_t, C_t):
    """One decode step of the recurrence (``selective_scan.py:365-380``).

    ``state [s, h, ds, dh]`` fp32 per-slot carry, ``x_t [s, h, dh]``,
    ``dt_t [s, h]`` (post-softplus), ``A [h]``, ``B_t/C_t [s, ds]``.
    Returns ``(y_t [s, h, dh]`` in x's dtype, ``state'`` fp32). Plain
    torch, shared by the compiled step and the eager engine."""
    dtf = dt_t.float()
    a = torch.exp(dtf * A.float())                              # s h
    dtx = dtf[..., None] * x_t.float()                          # s h dh
    new = a[..., None, None] * state + torch.einsum(
        "sn,shd->shnd", B_t.float(), dtx)
    y = torch.einsum("sn,shnd->shd", C_t.float(), new)
    return y.to(x_t.dtype), new
