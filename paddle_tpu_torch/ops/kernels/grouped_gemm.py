"""Grouped (ragged) GEMMs for the MoE expert MLP: the CUDA kernels
``csrc/grouped_gemm.cu`` (gmm, gmm2, tgmm), their plain twins, the
sort-based dispatch and combine, and the expert MLP built from them.

Port of ``paddle_tpu/ops/pallas/grouped_gemm.py``. Tokens sit expert-major
in a flat ``[E * c_pad, K]`` buffer: expert ``e`` owns rows ``[e*c_pad,
(e+1)*c_pad)``, of which the first ``counts[e]`` are live and the rest
zero. Contracts, as in the TPU kernels:

* ``gmm(x, w, counts)``: ``out[r] = x[r] @ w[e]`` in fp32, rounded to
  ``x``'s dtype, zero in the rows past ``counts[e]``;
* ``gmm2(x, w1, w2, counts)``: both products from one read of ``x``;
* ``tgmm(x, dy, counts)``: ``dw[e] = x_e^T @ dy_e`` over the live rows, fp32.

:class:`GmmFunction` and :class:`Gmm2Function` are the TPU package's
``custom_vjp`` pairs: the gradient of ``x`` is ``gmm`` against ``w[e]^T``
(:func:`gmm_t`, which reads ``w`` transposed in place), the gradient of
``w`` is :func:`tgmm`, cast to ``w``'s dtype.

``c_pad`` is the capacity rounded up to :data:`BLOCK_M`, the row tile of
the fp32 kernels (:func:`padded_capacity`, where the reference's
``default_blocks`` picked a tile per shape for the TPU's VMEM); no output
depends on it. Nothing is padded or transposed in memory, and gmm2's tile
always fits (the reference's VMEM fit test ``fused_block_n`` has no
counterpart). Each bf16 call takes one of two routes, chosen by
:func:`_tma_ok` from its shape and alignment alone, before the launch:

* K and N multiples of 8 and every operand 16-byte aligned (TMA's
  strides and bases): the ``wgmma`` kernels over TMA rings. Their boxes
  stop at each expert's ``c_pad`` rows, so a ``c_pad`` that is no multiple
  of their tiles needs no padding, and tgmm zeroes the rows past each
  count inside the kernel;
* any other K, N or base: the WMMA kernels, which mask the ragged edge of
  any K and N and read any base.

fp32 calls take the CUDA-core kernels, which mask any K and N.

On CPU tensors the wrappers run the plain twins; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["BLOCK_M", "padded_capacity", "fast_path_enabled", "eligible",
           "gmm", "gmm_t", "gmm2", "tgmm", "gmm_plain", "gmm2_plain", "tgmm_plain",
           "GmmFunction", "Gmm2Function", "sorted_dispatch",
           "sorted_combine", "expert_mlp", "launches", "launches_bwd",
           "launches_gmm2", "launches_tgmm"]

#: gmm launches in a forward (never by a twin)
launches = 0
#: gmm launches in a backward: the dx against ``w[e]^T``
launches_bwd = 0
#: gmm2 launches
launches_gmm2 = 0
#: tgmm launches
launches_tgmm = 0

#: buffer rows per block of the kernels (``kBM`` in the .cu)
BLOCK_M = 64

_COMBOS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
           (torch.float32, torch.bfloat16)}


def padded_capacity(capacity: int) -> int:
    """``c_pad``: an expert's rows in the buffer, the capacity rounded up
    to the kernels' row tile."""
    return -(-capacity // BLOCK_M) * BLOCK_M


def fast_path_enabled() -> bool:
    """The ``moe_grouped_gemm`` flag (``grouped_gemm.py:129-145``):
    ``auto`` and ``on`` take the grouped GEMMs on every device (the kernels
    for CUDA tensors, the twins for CPU tensors), where the reference's
    ``auto`` takes them on the TPU only; ``off`` takes the index-form
    scatter/vmap path. Any other value raises. ``use_pallas_kernels`` does
    not enter here: in the port it gates the KV handoff's transport
    alone."""
    mode = str(flags.flag("moe_grouped_gemm")).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"moe_grouped_gemm must be 'auto', 'on' or 'off', "
                         f"got {mode!r}")
    return mode != "off"


def eligible(num_experts: int, capacity: int, k: int, n: int,
             dtype) -> bool:
    """Whether the kernels take an expert GEMM of ``num_experts`` groups
    of ``capacity`` rows, contraction ``k`` and output width ``n`` in
    ``dtype`` (``grouped_gemm.py:119-126``): fp32 and bf16 only, where the
    reference takes any floating dtype its VMEM tiles fit. The caller
    routes what this refuses to the index-form path before any launch."""
    return (min(num_experts, capacity, k, n) >= 1
            and dtype in (torch.float32, torch.bfloat16))


# ------------------------------------------------------------- the twins
def _live(counts: torch.Tensor, c_pad: int, device) -> torch.Tensor:
    """``[E, c_pad, 1]`` mask of each expert's live rows."""
    rows = torch.arange(c_pad, device=device)
    return (rows[None, :] < counts.to(device).long()[:, None])[..., None]


def gmm_plain(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor,
              trans_w: bool = False) -> torch.Tensor:
    """The kernel's math: per expert ``x_e @ w[e]`` (``w[e]^T`` with
    ``trans_w``) from fp32 products, zero past ``counts[e]``, in x's
    dtype."""
    rows, k = x.shape
    e = w.shape[0]
    c_pad = rows // e
    wt = w.transpose(1, 2) if trans_w else w
    out = torch.bmm(x.reshape(e, c_pad, k).float(), wt.float())
    out = torch.where(_live(counts, c_pad, x.device), out,
                      torch.zeros((), device=x.device))
    return out.reshape(rows, -1).to(x.dtype)


def gmm2_plain(x, w1, w2, counts):
    return gmm_plain(x, w1, counts), gmm_plain(x, w2, counts)


def tgmm_plain(x: torch.Tensor, dy: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """``dw[e] = x_e^T @ dy_e`` over the live rows, fp32 ``[E, K, N]``."""
    rows, k = x.shape
    e = counts.shape[0]
    c_pad = rows // e
    live = _live(counts, c_pad, x.device)
    zero = torch.zeros((), device=x.device)
    xe = torch.where(live, x.reshape(e, c_pad, k).float(), zero)
    dye = torch.where(live, dy.reshape(e, c_pad, -1).float(), zero)
    return torch.bmm(xe.transpose(1, 2), dye)


# ----------------------------------------------------------- the wrappers
def _check(what: str, x, ws, counts, trans_w: bool):
    """Shapes, dtypes and devices of a gmm/gmm2 call; ``(E, c_pad, K, N,
    device)``."""
    _launch.require(x.dim() == 2 and all(w.dim() == 3 for w in ws),
                    f"{what}: expected x [rows, K] and w [E, K, N], got "
                    f"{tuple(x.shape)} and {[tuple(w.shape) for w in ws]}")
    e = ws[0].shape[0]
    rows, k = x.shape
    kw, n = ((ws[0].shape[2], ws[0].shape[1]) if trans_w
             else (ws[0].shape[1], ws[0].shape[2]))
    _launch.require(all(w.shape == ws[0].shape and w.dtype == ws[0].dtype
                        for w in ws), f"{what}: the weight stacks differ")
    _launch.require(kw == k, f"{what}: x K={k} vs w K={kw}")
    _launch.require(e > 0 and rows % e == 0,
                    f"{what}: rows={rows} not a multiple of E={e}")
    _launch.require(counts.shape == (e,) and counts.dtype == torch.int32,
                    f"{what}: counts must be int32 [{e}], got {counts.dtype} "
                    f"{tuple(counts.shape)}")
    _launch.require((x.dtype, ws[0].dtype) in _COMBOS,
                    f"{what}: x {x.dtype} with w {ws[0].dtype} is not taken "
                    f"(bf16 x bf16, fp32 x fp32 or fp32 x bf16)")
    dev = _launch.check_cuda(what, x, counts, *ws)
    return e, rows // e, k, n, dev


def _tma_ok(k: int, n: int, *tensors: torch.Tensor) -> bool:
    """Whether a bf16 call of contraction or row width ``k`` and output
    width ``n`` over ``tensors`` takes the ``wgmma`` route: TMA needs row
    strides of a multiple of 16 bytes (K and N multiples of 8) and
    16-byte-aligned bases. Otherwise the call takes the WMMA kernels."""
    return (k % 8 == 0 and n % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch_gmm(what, x, w1, w2, counts, trans_w):
    ws = [w1] if w2 is None else [w1, w2]
    e, c_pad, k, n, dev = _check(what, x, ws, counts, trans_w)
    outs = [torch.empty((x.shape[0], n), dtype=x.dtype, device=dev)
            for _ in ws]
    tma = x.dtype == torch.bfloat16 and _tma_ok(k, n, x, *ws)
    _launch.launch("ptt_gmm", x.data_ptr(), w1.data_ptr(),
                   None if w2 is None else w2.data_ptr(), outs[0].data_ptr(),
                   None if w2 is None else outs[1].data_ptr(),
                   counts.data_ptr(), e, c_pad, k, n, int(trans_w),
                   _launch.dtype_code(x, what),
                   _launch.dtype_code(w1, what), int(tma),
                   _launch.stream_of(dev))
    return outs


def gmm(x: torch.Tensor, w: torch.Tensor,
        counts: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM ``x [E*c_pad, K]`` by ``w [E, K, N]`` -> ``[E*c_pad,
    N]`` in x's dtype. CPU tensors take the twin; CUDA tensors launch the
    kernel."""
    global launches
    if x.device.type == "cpu":
        return gmm_plain(x, w, counts)
    out = _launch_gmm("gmm", x, w, None, counts, False)[0]
    launches += 1
    return out


def gmm_t(dy: torch.Tensor, w: torch.Tensor,
          counts: torch.Tensor) -> torch.Tensor:
    """The dx of :func:`gmm`: ``dy [E*c_pad, N]`` by ``w[e]^T`` for ``w
    [E, K, N]``, read transposed in place -> ``[E*c_pad, K]``."""
    global launches_bwd
    if dy.device.type == "cpu":
        return gmm_plain(dy, w, counts, trans_w=True)
    out = _launch_gmm("gmm_t", dy, w, None, counts, True)[0]
    launches_bwd += 1
    return out


def gmm2(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
         counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gmm(x, w1), gmm(x, w2))`` from one read of each x tile."""
    global launches_gmm2
    if x.device.type == "cpu":
        return gmm2_plain(x, w1, w2, counts)
    o1, o2 = _launch_gmm("gmm2", x, w1, w2, counts, False)
    launches_gmm2 += 1
    return o1, o2


def tgmm(x: torch.Tensor, dy: torch.Tensor,
         counts: torch.Tensor) -> torch.Tensor:
    """``dw [E, K, N]`` fp32 of :func:`gmm` for ``x [E*c_pad, K]`` and ``dy
    [E*c_pad, N]`` of one dtype, over each expert's first ``counts[e]``
    rows whatever the rows after them hold. The same bits on every run:
    each output tile sums its expert's rows in order, with no atomics."""
    global launches_tgmm
    if x.device.type == "cpu":
        return tgmm_plain(x, dy, counts)
    _launch.require(x.dim() == 2 and dy.dim() == 2
                    and dy.shape[0] == x.shape[0] and dy.dtype == x.dtype,
                    f"tgmm: x {tuple(x.shape)} {x.dtype} and dy "
                    f"{tuple(dy.shape)} {dy.dtype} must share rows and dtype")
    e = counts.shape[0]
    rows, k = x.shape
    n = dy.shape[1]
    _launch.require(counts.dim() == 1 and counts.dtype == torch.int32
                    and e > 0 and rows % e == 0,
                    f"tgmm: counts must be int32 [E] with E dividing "
                    f"rows={rows}, got {counts.dtype} {tuple(counts.shape)}")
    dev = _launch.check_cuda("tgmm", x, dy, counts)
    dw = torch.empty((e, k, n), dtype=torch.float32, device=dev)
    tma = x.dtype == torch.bfloat16 and _tma_ok(k, n, x, dy)
    _launch.launch("ptt_tgmm", x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                   counts.data_ptr(), e, rows // e, k, n,
                   _launch.dtype_code(x, "tgmm"), int(tma),
                   _launch.stream_of(dev))
    launches_tgmm += 1
    return dw


# --------------------------------------------------------------- autograd
class GmmFunction(torch.autograd.Function):
    """:func:`gmm` forward; backward ``dx = gmm_t(dy, w)``, ``dw =
    tgmm(x, dy)`` cast to w's dtype (``grouped_gemm.py:256-268``)."""

    @staticmethod
    def forward(ctx, x, w, counts):
        x = x.contiguous()
        ctx.save_for_backward(x, w, counts)
        return gmm(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        return (gmm_t(dy, w, counts), tgmm(x, dy, counts).to(w.dtype),
                None)


class Gmm2Function(torch.autograd.Function):
    """:func:`gmm2` forward; backward ``dx`` the sum of two ``gmm_t``
    results in x's dtype, ``dw1``/``dw2`` from :func:`tgmm`
    (``grouped_gemm.py:343-357``)."""

    @staticmethod
    def forward(ctx, x, w1, w2, counts):
        x = x.contiguous()
        ctx.save_for_backward(x, w1, w2, counts)
        return gmm2(x, w1, w2, counts)

    @staticmethod
    def backward(ctx, dy1, dy2):
        x, w1, w2, counts = ctx.saved_tensors
        dy1 = dy1.to(x.dtype).contiguous()
        dy2 = dy2.to(x.dtype).contiguous()
        dx = gmm_t(dy1, w1, counts) + gmm_t(dy2, w2, counts)
        return (dx, tgmm(x, dy1, counts).to(w1.dtype),
                tgmm(x, dy2, counts).to(w2.dtype), None)


# ------------------------------------------------------ dispatch / combine
def sorted_dispatch(tokens: torch.Tensor, e_idx: torch.Tensor,
                    slot: torch.Tensor, keep: torch.Tensor, num_experts: int,
                    c_pad: int):
    """``tokens [N, M]`` and the gate's index routing -> ``(x_buf [E*c_pad,
    M], counts [E] int32, dest [N*K] int32)``, as the reference's
    (``grouped_gemm.py:484``): ``dest = e*c_pad + slot`` for a kept
    ``(token, k)``, ``E*c_pad`` for a dropped one. The inverse permutation
    is one scatter whose targets are all distinct (each dropped entry gets
    its own row past the buffer), and the payload moves by an
    ``F.embedding`` gather, whose backward sums without atomics, so a
    training step repeats bitwise. Rows past each count are zero."""
    n, _ = tokens.shape
    k = e_idx.shape[1]
    nk = n * k
    t_rows = num_experts * c_pad
    flat_e = e_idx.reshape(-1).long()
    valid = keep.reshape(-1)
    order = torch.arange(nk, device=tokens.device)
    dest = torch.where(valid, flat_e * c_pad + slot.reshape(-1).long(),
                       torch.full_like(order, t_rows))
    target = torch.where(valid, dest, t_rows + order)
    inv = torch.full((t_rows + nk,), nk, dtype=torch.long,
                     device=tokens.device).scatter_(0, target, order)[:t_rows]
    live = inv < nk
    src = torch.where(live, inv, torch.zeros_like(inv)) // k
    x_buf = F.embedding(src, tokens) * live.to(tokens.dtype)[:, None]
    counts = (F.one_hot(flat_e, num_experts) * valid.long()[:, None]).sum(0)
    return x_buf, counts.to(torch.int32), dest.to(torch.int32)


def sorted_combine(y_buf: torch.Tensor, dest: torch.Tensor,
                   weight: torch.Tensor, keep: torch.Tensor, n: int):
    """Mirror of :func:`sorted_dispatch` (``grouped_gemm.py:514``): each
    token's expert rows gathered back through ``dest`` and summed with the
    gate weights; a dropped slot carries weight 0."""
    k = dest.shape[0] // n
    rows = F.embedding(dest.long().clamp(max=y_buf.shape[0] - 1), y_buf)
    wk = (weight.reshape(-1).to(y_buf.dtype)
          * keep.reshape(-1).to(y_buf.dtype))
    return (rows * wk[:, None]).reshape(n, k, -1).sum(dim=1)


def expert_mlp(x_buf, counts, wg, wu, wd, plain: bool = False):
    """The SwiGLU expert MLP ``down(silu(gate(x)) * up(x))`` over the
    expert-major buffer as grouped GEMMs (``grouped_gemm.py:437``): gate
    and up through :func:`gmm2` when ``moe_fused_wi`` is on, else two
    :func:`gmm` calls. The weights go in as they are: an fp32 buffer with
    bf16 weights (the serving step) is widened inside the kernel, which
    computes what the reference's per-call ``w.astype(fp32)`` does.
    ``plain`` runs the twins (a reference for checking the kernels, not a
    fallback)."""
    if plain:
        hg, hu = gmm2_plain(x_buf, wg, wu, counts)
        return gmm_plain(F.silu(hg) * hu, wd, counts)
    if flags.flag("moe_fused_wi"):
        hg, hu = Gmm2Function.apply(x_buf, wg, wu, counts)
    else:
        hg = GmmFunction.apply(x_buf, wg, counts)
        hu = GmmFunction.apply(x_buf, wu, counts)
    return GmmFunction.apply(F.silu(hg) * hu, wd, counts)
