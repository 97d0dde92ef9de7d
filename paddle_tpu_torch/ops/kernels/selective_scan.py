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
its reason.

Gradients: on CUDA a call that needs them goes through
:class:`ScanFunction`, whose backward is a kernel of its own
(``ptt_selective_scan_bwd`` in the same source): what the reference's
``jax.vjp`` of the chunked form computes (``selective_scan.py:237``; no TPU
kernel), from the fp32 state entering each chunk that the forward keeps.
Its plain twin is :func:`scan_chunked_bwd_plain`, the same algorithm
written out. On the CPU autograd differentiates the chunked twin. bf16 at
head dim and d_state 64 or 128 on aligned bases takes the ``wgmma`` route
(:func:`bwd_route`; a block walks a group of heads, :func:`bwd_head_group`),
every other call the edge route (``mma.sync`` in bf16, CUDA cores in fp32);
:func:`bwd_launch_plan` mirrors both routes' grids and shared memory.

Single-token decode never scans: :func:`selective_scan_update` is the
recurrence's one step, plain torch as in the reference.
"""

from __future__ import annotations

import functools

from typing import Optional, Tuple

import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["selective_scan", "scan_chunked", "scan_chunked_bwd",
           "scan_chunked_bwd_plain", "ScanFunction", "xla_selective_scan",
           "selective_scan_update", "ineligible_reason", "resolve_chunk",
           "launch_plan", "bwd_launch_plan", "bwd_ineligible_reason",
           "bwd_route", "bwd_head_group", "launches", "launches_bwd"]

#: kernel launches made by :func:`scan_chunked` (never by the twins)
launches = 0
#: backward kernel launches made by :func:`scan_chunked_bwd`
launches_bwd = 0

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


# ------------------------------------------------------- backward's plan
def _pad_el(esize: int) -> int:
    """A shared-memory row's pad (``pad_el``): 16 bytes."""
    return 16 // esize


def _bwd_u_smem(L, dh, ds, R, esize) -> int:
    """``scan_bwd_chunk_u``'s (``bwd_u_smem``): cs and exp(cs), a k-tile
    of C and of dy rows, the chunk's fp32 U."""
    p = _pad_el(esize)
    return (2 * _align16(L * 4) + _align16(R * (ds + p) * esize)
            + _align16(R * (dh + p) * esize) + _align16(ds * (dh + 4) * 4))


def _bwd_rows_smem(L, dh, ds, R, esize) -> int:
    """``scan_bwd_rows``'s (``bwd_rows_smem``): cs, exp(cs_i) and the row
    sums, dy_i and X_j, C_i and B_j, S_prev, G/dG and dM/dP tiles, dC."""
    p = _pad_el(esize)
    return (_align16(L * 4) + 2 * _align16(R * 4)
            + 2 * _align16(R * (dh + p) * esize)
            + 2 * _align16(R * (ds + p) * esize) + _align16(ds * (dh + 4) * 4)
            + 2 * _align16(R * (R + 4) * 4) + _align16(R * (ds + 4) * 4))


def _bwd_cols_smem(L, dh, ds, R, esize) -> int:
    """``scan_bwd_cols``'s (``bwd_cols_smem``): cs, exp(T - cs_j), the
    column sums and q, X_j and dy_i, B_j and C_i, dS, Mr in x's dtype,
    G/dG and dM/dP tiles, dX and dB."""
    p = _pad_el(esize)
    return (_align16(L * 4) + 3 * _align16(R * 4)
            + 2 * _align16(R * (dh + p) * esize)
            + 2 * _align16(R * (ds + p) * esize) + _align16(ds * (dh + 4) * 4)
            + _align16(R * (R + p) * esize) + 2 * _align16(R * (R + 4) * 4)
            + _align16(R * (dh + 4) * 4) + _align16(R * (ds + 4) * 4))


def bwd_tile_rows(L: int, dh: int, ds: int, esize: int) -> int:
    """The backward's tile rows (``bwd_tile_rows``): the largest of 64,
    32, 16 (and 8 in fp32, whose products need no 16-row tile) up to
    ``L`` whose three tiled kernels fit; 0 where none does."""
    for R in (64, 32, 16, 8) if esize == 4 else (64, 32, 16):
        if R <= L and max(_bwd_u_smem(L, dh, ds, R, esize),
                          _bwd_rows_smem(L, dh, ds, R, esize),
                          _bwd_cols_smem(L, dh, ds, R, esize)) <= _SMEM_LIMIT:
            return R
    return 0


# the wgmma route's tiled launches (``namespace wgb`` in the .cu)
_WG_CONSUMERS = 128       # one warpgroup, and a producer warp
_WG_FILL = 4 * 132        # two waves of two blocks an SM (``kFill``)
_WG_MAX_GROUP = 16        # heads a block at most (``kMaxGroup``)
_SMEM_ALIGN = 1024        # swizzle atoms' alignment slack (``kSmemAlign``)


def bwd_route(x_shape, d_state: int, chunk: int, dtype,
              aligned: bool = True) -> str:
    """The backward's route (``wgmma_ok`` in the .cu): ``"wgmma"`` for bf16
    at head dim and d_state 64 or 128, a chunk of whole 64-row tiles and
    16-byte-aligned bases of dtx, B, C and dy (``aligned``); else
    ``"edge"``: ``mma.sync`` in bf16, the CUDA cores in fp32."""
    dh = int(tuple(x_shape)[-1])
    if (dtype == torch.bfloat16 and dh in (64, 128)
            and int(d_state) in (64, 128) and int(chunk) % 64 == 0
            and aligned):
        return "wgmma"
    return "edge"


def bwd_head_group(h: int, base: int) -> Tuple[int, int]:
    """``(heads a block, groups)`` of the wgmma route's tiled launches
    (``heads_a_block``): ``ceil(h / groups)`` heads for the fewest groups
    that give ``base`` x groups >= two waves of two blocks an SM, at most
    16 heads a block and no more groups than heads; the last group may be
    smaller."""
    groups = max(-(-_WG_FILL // base), -(-h // _WG_MAX_GROUP))
    groups = min(groups, h)
    g = -(-h // groups)
    return g, -(-h // g)


def _wg_stages(dh: int, ds: int) -> int:
    """Item-ring stages (``stages``): 3 at 128 / 128, else 4."""
    return 3 if (dh, ds) == (128, 128) else 4


def _wg_smem(side: str, dh: int, ds: int, L: int, g: int) -> int:
    """A tiled launch's dynamic shared memory (``smem_rows`` /
    ``smem_cols``): the resident 64-row tile of C (rows) or B (cols), the
    two-stage outer ring (B_j tiles; x_j tiles of a head), the item ring's
    slot A (a dy tile) and slot B (ds x dh bf16), cs * log2(e) of the
    group's heads, the row sums (rows), the barriers and the slack."""
    S = _wg_stages(dh, ds)
    outer = 2 * 64 * ds * 2 if side == "rows" else 2 * 64 * dh * 2
    tiles = 64 * ds * 2 + outer + S * (64 * dh * 2 + ds * dh * 2)
    sums = g * 64 * 4 if side == "rows" else 0
    return tiles + g * L * 4 + sums + (5 + 2 * S) * 8 + _SMEM_ALIGN


def _wg_smem_u(dh: int, ds: int, L: int, g: int) -> int:
    """The wgmma route's chunk U (``smem_chunk_u``): the chunk's C, a
    4-stage ring of 64-row dy pieces, two buffers of the scaled pieces'
    hi and lo terms, the group's cs, the barriers and the slack."""
    return L * ds * 2 + 8 * 64 * dh * 2 + g * L * 4 + 9 * 8 + _SMEM_ALIGN


def bwd_launch_plan(bsz: int, lp: int, h: int, dh: int, ds: int, L: int,
                    esize: int, route: Optional[str] = None) -> dict:
    """The backward's six launches (``launch_bwd`` / ``launch_bwd_wgmma``
    in the .cu): tile rows ``R``, each launch's grid (x, y, z), threads
    and dynamic shared memory, the route (``route`` None: the shape's, on
    aligned bases) and, on the wgmma route (chunk U and the two tiled
    launches on ``wgmma``, 64-row tiles), the heads a block, the groups,
    the ring's stages, blocks an SM by ``__launch_bounds__`` and the bytes
    the dB / dC partials move (written once, read once)."""
    if route is None:
        route = bwd_route((bsz, lp, h, dh), ds, L,
                          torch.bfloat16 if esize == 2 else torch.float32)
    R = bwd_tile_rows(L, dh, ds, esize)
    nc = lp // L
    plan = dict(
        route=route, rows=R, threads=256,
        chunk_u=dict(grid=(nc, bsz, h), smem=_bwd_u_smem(L, dh, ds, R, esize)),
        passes=dict(grid=(-(-bsz * h * ds * dh // 256), 1, 1), smem=0),
        dla=dict(grid=(nc, bsz * h, 1), smem=0))
    if route == "wgmma":
        nrt = L // 64
        gu, groups_u = bwd_head_group(h, bsz * nc)
        plan.update(rows=64, chunk_u=dict(
            grid=(bsz * nc * groups_u, 1, 1), threads=_WG_CONSUMERS + 32,
            heads=gu, smem=_wg_smem_u(dh, ds, L, gu)))
        g, groups = bwd_head_group(h, bsz * nc * nrt)
        tiled = dict(grid=(bsz * nc * groups, nrt, 1),
                     threads=_WG_CONSUMERS + 32,
                     stages=_wg_stages(dh, ds),
                     blocks_per_sm=2 if (dh, ds) == (64, 64) else 1)
        plan.update(
            heads=g, groups=groups,
            rows_kernel=dict(tiled, smem=_wg_smem("rows", dh, ds, L, g)),
            cols_kernel=dict(tiled, smem=_wg_smem("cols", dh, ds, L, g)),
            dbc=dict(grid=(-(-bsz * lp * ds // 256), 1, 1), smem=0,
                     parts=groups),
            partial_bytes=2 * 2 * bsz * groups * lp * ds * 4)
    else:
        nrt = -(-L // R) if R else 0
        plan.update(
            heads=1, groups=h,
            rows_kernel=dict(grid=(nrt, nc, bsz * h), threads=256,
                             smem=_bwd_rows_smem(L, dh, ds, R, esize)),
            cols_kernel=dict(grid=(nrt, nc, bsz * h), threads=256,
                             smem=_bwd_cols_smem(L, dh, ds, R, esize)),
            dbc=dict(grid=(-(-bsz * lp * ds // 256), 1, 1), smem=0, parts=h),
            partial_bytes=2 * 2 * bsz * h * lp * ds * 4)
    return plan


def bwd_scratch_floats(bsz: int, lp: int, h: int, dh: int, ds: int,
                       L: int, route: str = "edge") -> int:
    """fp32 scratch the backward takes (the .cu's carves): cs, each chunk's
    U / dS, the r, c and q rows and the dB and dC partials (a head's on
    the edge route, a group's on the wgmma route, which also keeps the
    state pass's four bf16 planes of dS and S_prev: two floats an entry of
    the states)."""
    n_cs = bsz * h * lp
    n_st = (lp // L) * bsz * h * ds * dh
    if route == "wgmma":
        groups = bwd_head_group(h, bsz * (lp // L) * (L // 64))[1]
        return 4 * n_cs + n_st + 2 * bsz * groups * lp * ds + 2 * n_st
    return 5 * n_cs + n_st + 2 * n_cs * ds


def bwd_ineligible_reason(x_shape, d_state: int, chunk: int,
                          dtype) -> Optional[str]:
    """Why the backward kernel cannot take this shape (the forward's
    reasons first), or None."""
    reason = ineligible_reason(x_shape, d_state, chunk, dtype)
    if reason is not None:
        return reason
    bsz, l, h, dh = tuple(x_shape)
    esize = 4 if dtype == torch.float32 else 2
    if bwd_tile_rows(int(chunk), dh, int(d_state), esize) == 0:
        R = 8 if esize == 4 else 16
        smem = _bwd_cols_smem(int(chunk), dh, int(d_state), R, esize)
        return (f"backward shared memory {smem} B exceeds {_SMEM_LIMIT} B "
                f"at chunk={chunk} (dh={dh}, d_state={d_state})")
    if max(bsz, 1) * h > 65535:
        return f"backward grid: batch x heads {bsz * h} > 65535"
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


def _scan_reference(dtx, la_t, B, C, chunk: int, with_states: bool = False):
    """The kernel's plain twin: :func:`_chunk_math` driven by a loop over
    the chunks. ``dtx [b, lp, h, dh]``, ``la_t [b, h, lp]`` fp32, ``B/C
    [b, lp, ds]``, ``lp`` a multiple of ``chunk``. Returns ``(y [b, lp, h,
    dh]`` in dtx's dtype, ``state [b, h, ds, dh]`` fp32)``; with
    ``with_states`` also the state entering each chunk, ``[b, lp / chunk,
    h, ds, dh]`` fp32 (what the kernel's forward keeps for its backward)."""
    bsz, lp, h, dh = dtx.shape
    ds = B.shape[-1]
    s = torch.zeros(bsz, h, ds, dh, dtype=torch.float32, device=dtx.device)
    ys, entering = [], []
    for c0 in range(0, lp, chunk):
        sl = slice(c0, c0 + chunk)
        entering.append(s)
        y, s = _chunk_math(dtx[:, sl].transpose(1, 2), la_t[..., sl],
                           B[:, sl], C[:, sl], s)
        ys.append(y.to(dtx.dtype))
    y = torch.cat(ys, dim=2).transpose(1, 2)
    if with_states:
        return y, s, torch.stack(entering, dim=1)
    return y, s


def scan_chunked_bwd_plain(dtx, la_t, B, C, states, dy, ds_final,
                           chunk: int):
    """The backward kernel's plain twin: its algorithm written out (no
    autograd), chunk by chunk in reverse. ``states [b, lp / chunk, h, ds,
    dh]`` fp32 the state entering each chunk; ``dy`` like ``dtx``;
    ``ds_final [b, h, ds, dh]`` the final state's cotangent or None
    (zeros). Per chunk, with ``D = exp(cs_i - cs_j)`` on ``j <= i``, ``G =
    C B^T``, ``M = G o D`` and ``Mr`` M rounded to x's dtype, ``dS`` the
    cotangent of the state leaving the chunk: ``dX = Mr^T dy + (B o
    e^{T-cs}) dS``; ``dM = dy X^T``, ``dG = dM o D``, ``dP = dM o M``;
    ``dC += dG B + (dy S_prev^T) o e^{cs}``; ``dB += dG^T C + (X dS^T) o
    e^{T-cs}`` (summed over the heads); ``dcs`` from dP's rows (+) and
    columns (-), the two decayed terms and ``e^T <dS, S_prev>``; ``d_la``
    its reverse cumsum; ``dS_prev = e^T dS + (C o e^{cs})^T dy``. Returns
    ``(d_dtx, d_la_t, dB, dC)`` in the inputs' dtypes."""
    bsz, lp, h, dh = dtx.shape
    ds, L, dev = B.shape[-1], int(chunk), dtx.device
    f32 = torch.float32
    dS = (torch.zeros(bsz, h, ds, dh, dtype=f32, device=dev)
          if ds_final is None else ds_final.float())
    d_dtx = torch.empty_like(dtx)
    d_la = torch.empty(bsz, h, lp, dtype=f32, device=dev)
    dB = torch.empty(bsz, lp, ds, dtype=f32, device=dev)
    dC = torch.empty(bsz, lp, ds, dtype=f32, device=dev)
    causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
    for c in reversed(range(lp // L)):
        sl = slice(c * L, (c + 1) * L)
        X = dtx[:, sl].transpose(1, 2).float()                  # b h L dh
        Y = dy[:, sl].transpose(1, 2).float()
        Bc, Cc = B[:, sl].float()[:, None], C[:, sl].float()[:, None]
        sp = states[:, c]                                       # b h ds dh
        cs = torch.cumsum(la_t[..., sl], dim=-1)                # b h L
        total = cs[..., -1:]
        D = torch.exp((cs[..., :, None] - cs[..., None, :])
                      .masked_fill(~causal, float("-inf")))
        M = torch.matmul(Cc, Bc.transpose(-1, -2)) * D          # b h L L
        dM = torch.matmul(Y, X.transpose(-1, -2))
        dG, dP = dM * D, dM * M
        eb, ec = torch.exp(total - cs)[..., None], torch.exp(cs)[..., None]
        b_in = Bc * eb                                          # b h L ds
        E = torch.matmul(Y, sp.transpose(-1, -2)) * ec          # b h L ds
        F = torch.matmul(X, dS.transpose(-1, -2))
        dX = (torch.matmul(M.to(dtx.dtype).float().transpose(-1, -2), Y)
              + torch.matmul(b_in, dS))
        dC[:, sl] = (torch.matmul(dG, Bc) + E).sum(1)
        dB[:, sl] = (torch.matmul(dG.transpose(-1, -2), Cc) + F * eb).sum(1)
        q = (F * b_in).sum(-1)                                  # b h L
        dcs = dP.sum(-1) - dP.sum(-2) + (E * Cc).sum(-1) - q
        dcs[..., -1] += q.sum(-1) + torch.exp(total[..., 0]) * (
            dS * sp).sum((-1, -2))
        d_la[..., sl] = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1),
                                   [-1])
        d_dtx[:, sl] = dX.transpose(1, 2).to(dtx.dtype)
        dS = (torch.exp(total)[..., None] * dS
              + torch.matmul((Cc * ec).transpose(-1, -2), Y))
    return d_dtx, d_la, dB.to(B.dtype), dC.to(C.dtype)


def _scan_launch(dtx, la_t, B, C, chunk: int):
    """The forward kernel's call: ``(y, state, states)``, the last the
    fp32 state entering each chunk (its scratch after the call)."""
    global launches
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
    st = scratch[n_cs:].view(bsz, lp // chunk, h, ds, dh)
    return y, state, st


def scan_chunked_bwd(dtx, la_t, B, C, states, dy, ds_final, chunk: int):
    """The backward of :func:`scan_chunked` (see
    :func:`scan_chunked_bwd_plain`): ``(d_dtx, d_la_t, dB, dC)``. CPU
    tensors take the twin; CUDA tensors launch the kernel on the route
    :func:`bwd_route` picks from shape and alignment (passed as the C
    entry's ``tma`` flag), or raise for a shape it cannot take."""
    global launches_bwd
    if dtx.device.type == "cpu":
        return scan_chunked_bwd_plain(dtx, la_t, B, C, states, dy, ds_final,
                                      chunk)
    extra = () if ds_final is None else (ds_final,)
    dev = _launch.check_cuda("selective_scan_bwd", dtx, la_t, B, C, states,
                             dy, *extra)
    bsz, lp, h, dh = dtx.shape
    ds = B.shape[-1]
    reason = bwd_ineligible_reason(dtx.shape, ds, chunk, dtx.dtype)
    if reason is not None:
        raise ValueError(f"selective_scan_bwd: {reason}")
    f32 = torch.float32
    if not (lp % chunk == 0 and la_t.shape == (bsz, h, lp)
            and la_t.dtype == f32 and B.shape == (bsz, lp, ds)
            and C.shape == B.shape and B.dtype == dtx.dtype
            and C.dtype == dtx.dtype and dy.shape == dtx.shape
            and dy.dtype == dtx.dtype and states.dtype == f32
            and states.shape == (bsz, lp // chunk, h, ds, dh)
            and (ds_final is None or (ds_final.shape == (bsz, h, ds, dh)
                                      and ds_final.dtype == f32))):
        raise ValueError(
            f"selective_scan_bwd: dtx {tuple(dtx.shape)} {dtx.dtype}, la_t "
            f"{tuple(la_t.shape)} {la_t.dtype}, B/C {tuple(B.shape)} "
            f"{B.dtype}/{C.dtype}, states {tuple(states.shape)}, dy "
            f"{tuple(dy.shape)} {dy.dtype} at chunk {chunk}")
    route = bwd_route(dtx.shape, ds, chunk, dtx.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (dtx, B, C, dy)))
    if route == "edge":
        # the edge kernels copy rows with 16-byte cp.async: a misaligned
        # operand is copied once into an aligned buffer first
        dtx, B, C, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (dtx, B, C, dy))
    d_dtx = torch.empty_like(dtx)
    d_la = torch.empty_like(la_t)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    scratch = torch.empty(bwd_scratch_floats(bsz, lp, h, dh, ds, chunk,
                                             route),
                          dtype=f32, device=dev)
    _launch.launch("ptt_selective_scan_bwd", dtx.data_ptr(), la_t.data_ptr(),
                   B.data_ptr(), C.data_ptr(), states.data_ptr(),
                   dy.data_ptr(),
                   None if ds_final is None else ds_final.data_ptr(),
                   d_dtx.data_ptr(), d_la.data_ptr(), dB.data_ptr(),
                   dC.data_ptr(), scratch.data_ptr(), bsz, lp, h, dh, ds,
                   int(chunk), _launch.DTYPE_CODE[dtx.dtype],
                   int(route == "wgmma"), _launch.stream_of(dev))
    launches_bwd += 1
    return d_dtx, d_la, dB, dC


class ScanFunction(torch.autograd.Function):
    """The chunked scan on CUDA under autograd: the forward kernel, keeping
    the fp32 state entering each chunk (its scratch, so no extra launch);
    the backward kernel for ``(dtx, la_t, B, C)``. A missing cotangent of
    the final state is zeros; of y, zeros too."""

    @staticmethod
    def forward(ctx, dtx, la_t, B, C, chunk):
        y, state, states = _scan_launch(dtx, la_t, B, C, chunk)
        ctx.save_for_backward(dtx, la_t, B, C, states)
        ctx.chunk = int(chunk)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        dtx, la_t, B, C, states = ctx.saved_tensors
        dy = torch.zeros_like(dtx) if dy is None else dy.contiguous()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        grads = scan_chunked_bwd(dtx, la_t, B, C, states, dy, dstate,
                                 ctx.chunk)
        return (*grads, None)


def scan_chunked(dtx, la_t, B, C, chunk: int):
    """The chunked scan over padded inputs (see :func:`_scan_reference`):
    ``(y, state)``. CPU tensors take the twin (differentiable by autograd);
    CUDA tensors launch the kernel, through :class:`ScanFunction` when a
    gradient is wanted, or raise for a shape it cannot take."""
    if dtx.device.type == "cpu":
        return _scan_reference(dtx, la_t, B, C, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (dtx, la_t, B, C)):
        return ScanFunction.apply(dtx, la_t, B, C, chunk)
    return _scan_launch(dtx, la_t, B, C, chunk)[:2]


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
