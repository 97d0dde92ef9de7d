"""Expert-parallel ragged all-to-all MoE dispatch and combine (port of
``paddle_tpu/incubate/distributed/models/moe/moe_a2a.py``).

Routing stays GLOBAL: every rank of the ``ep`` axis routes every token, as
the reference's gate sees the full score matrix, so capacity drops are
those of the one-device path. Each rank then takes its ``n_local`` rows,
packs the (token, k) pairs bound for each rank's experts into ``bucket``
static slots, exchanges them with one tiled all-to-all, compacts what it
received expert-major and runs its ``E/ep`` local experts through the
grouped GEMMs; the outputs ride the mirrored exchange back and each token
sums its K expert rows with the gate weights. The backward pass runs the
mirrored exchanges.

``bucket = min(n_local*K, E_local*c_pad)`` is an exact bound: a rank
routes ``n_local*K`` pairs in all, and the globally kept pairs of an
expert never exceed the capacity, so no kept row is dropped. Expert GEMMs
are row-wise, so per-token results equal the one-device path's bit for
bit in fp32 (only row placement differs); weight gradients sum their rows
in another order.

With ``moe_a2a_overlap`` each rank's rows split into ``moe_a2a_chunks``
independent pipelines. With ``moe_a2a_fused_kernel`` on (the default) the
dispatch payload of every chunk and the expert MLP run in one launch of the
comm-fused kernel (#17); only the int32 expert ids ride a separate
exchange. Otherwise the pipelined composed path runs: the tiled exchange
(#15) carries the payload and its ids, the grouped GEMMs (#11-13) the
experts.

The reference's ``shard_map`` takes global arrays and shards the tokens
for the body only. Here every rank holds the same global tokens and
routing (the rest of the model runs replicated): :class:`_A2AGrouped`
slices the rank's rows, runs the exchange with its peers and all-gathers
the output; its backward takes the rank's rows of the cotangent and
all-gathers the tokens' gradient and the routing weights' gradient, so the
gate's gradient is the same bits on every rank and no all-reduce exists.
Off the a2a path, a layer that keeps one rank's block of the experts takes
the all-gather path (:func:`all_gather_experts`, the reference's GSPMD
buffer under ``ep_sharding``): every rank fills the whole expert-major
buffer from the replicated tokens, runs its block and all-gathers the
outputs; the backward all-gathers the buffer's gradient, and the experts'
gradients stay local. Mesh axes other than ``ep`` (data, sequence and tensor
parallelism of the experts) are ROADMAP.md A.10; the gauges and
flight-recorder records are A.12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import flags
from paddle_tpu_torch.distributed import collective as coll
from paddle_tpu_torch.ops.kernels import async_collectives as hops
from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

__all__ = ["a2a_enabled", "a2a_eligible", "a2a_ineligible_reason",
           "mesh_axis_split", "dispatch_local", "combine_local",
           "a2a_grouped_forward", "all_gather_experts"]

# mesh axes along which tokens are data-sharded (sequence axes shard tokens
# too) and those that shard the expert ffn dim: the reference's families
_DATA_AXES = {"dp", "data", "batch"}
_SEQ_AXES = {"sp", "sep", "seq"}
_MODEL_AXES = {"mp", "model", "tensor"}


def a2a_enabled() -> bool:
    """``moe_a2a_dispatch`` (``moe_a2a.py:62-75``): ``on`` forces the a2a
    path, ``auto`` follows the grouped-GEMM path
    (:func:`grouped_gemm.fast_path_enabled`), ``off`` keeps the all-gather
    path. Any other value raises."""
    mode = str(flags.flag("moe_a2a_dispatch")).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"moe_a2a_dispatch must be 'auto', 'on' or 'off', "
                         f"got {mode!r}")
    if mode == "auto":
        return gg.fast_path_enabled()
    return mode == "on"


def mesh_axis_split(mesh, ep_axis: str):
    """``(token_axes, model_axes)`` of the mesh, or None when an axis falls
    in neither family (pipeline, unknown)."""
    tok, model = [], []
    for name in mesh.dim_names:
        if name == ep_axis or name in _DATA_AXES or name in _SEQ_AXES:
            tok.append(name)
        elif name in _MODEL_AXES:
            model.append(name)
        else:
            return None
    return tuple(tok), tuple(model)


def a2a_ineligible_reason(mesh, ep_axis: str, num_experts: int,
                          n_tokens: int, ffn=None):
    """The structural reason this mesh and shape keep the one-device
    path, or None when the a2a path is eligible (the reference's rules)."""
    if mesh is None:
        return "no mesh installed"
    if ep_axis not in mesh.dim_names:
        return f"mesh {tuple(mesh.dim_names)} has no {ep_axis!r} axis"
    ep = mesh.get_dim_size(ep_axis)
    if ep <= 1:
        return f"ep axis {ep_axis!r} has size {ep} (needs > 1)"
    split = mesh_axis_split(mesh, ep_axis)
    if split is None:
        bad = [a for a in mesh.dim_names
               if a != ep_axis and a not in _DATA_AXES
               and a not in _SEQ_AXES and a not in _MODEL_AXES]
        return (f"mesh axis {bad[0]!r} is neither data "
                f"({sorted(_DATA_AXES)}), sequence ({sorted(_SEQ_AXES)}) "
                f"nor tensor ({sorted(_MODEL_AXES)}) — pipeline/unknown "
                f"axes keep the all-gather path")
    tok_axes, model_axes = split
    if num_experts % ep:
        return f"num_experts={num_experts} not divisible by ep={ep}"
    world_tok = int(np.prod([mesh.get_dim_size(a) for a in tok_axes]))
    if n_tokens % world_tok or n_tokens < world_tok:
        return (f"n_tokens={n_tokens} not divisible over the {world_tok} "
                f"token shards of axes {tok_axes}")
    if ffn is not None and model_axes:
        mp = int(np.prod([mesh.get_dim_size(a) for a in model_axes]))
        if ffn % mp:
            return (f"ffn={ffn} not divisible by the tensor-parallel degree "
                    f"{mp} of axes {model_axes}")
    return None


def a2a_eligible(mesh, ep_axis: str, num_experts: int, n_tokens: int,
                 ffn=None) -> bool:
    return a2a_ineligible_reason(mesh, ep_axis, num_experts, n_tokens,
                                 ffn=ffn) is None


def require_ep_only(mesh, ep_axis: str, what: str) -> None:
    """Expert parallelism over a mesh of the ``ep`` axis alone; data,
    sequence and tensor axes beside it are not ported."""
    others = [a for a in mesh.dim_names if a != ep_axis]
    if others:
        raise NotImplementedError(
            f"{what}: mesh axes {others} beside {ep_axis!r} (data, sequence "
            f"or tensor parallelism of the experts) are not ported yet "
            f"(ROADMAP.md A.10)")


# ------------------------------------------------- the all-gather path
class _EpBlock(torch.autograd.Function):
    """This rank's block of a buffer every rank of the ep group holds
    whole (dim 0 split in ``ep`` blocks). The backward all-gathers the
    ranks' block gradients, so that every rank holds the whole buffer's
    gradient and the tokens' gradients stay the same bits on every
    rank."""

    @staticmethod
    def forward(ctx, x, idx: int, ep: int, group):
        ctx.group = group
        rows = x.shape[0] // ep
        return x[idx * rows:(idx + 1) * rows].clone()

    @staticmethod
    def backward(ctx, dy):
        return coll.all_gather(dy.contiguous(), ctx.group, axis=0), None, \
            None, None


class _EpGather(torch.autograd.Function):
    """The ranks' blocks concatenated along dim 0 in rank order; the
    backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, y, idx: int, group):
        ctx.idx, ctx.rows = idx, y.shape[0]
        return coll.all_gather(y.contiguous(), group, axis=0)

    @staticmethod
    def backward(ctx, dy):
        r = ctx.rows
        return dy[ctx.idx * r:(ctx.idx + 1) * r].contiguous(), None, None


def all_gather_experts(fn, x, mesh, ep_axis: str, *leaves):
    """The all-gather expert path over sharded experts (the reference's
    GSPMD buffer, ``moe_layer.py:52-96`` and ``:271-296`` under
    ``ep_sharding``): ``x`` is the whole expert-major buffer, which every
    rank of the ep group fills from the replicated tokens; this rank runs
    ``fn(block, *leaves)`` on its block of ``E/ep`` experts with its
    stacked ``leaves`` and the blocks are all-gathered. The experts'
    gradients stay local; the buffer's gradient is all-gathered."""
    ep, idx = mesh.get_dim_size(ep_axis), mesh.axis_index(ep_axis)
    group = mesh.group(ep_axis)
    y = fn(_EpBlock.apply(x, idx, ep, group), *leaves)
    return _EpGather.apply(y, idx, group)


# --------------------------------------------------------- the rank's half
def _pairs(e_idx, keep, e_local: int):
    """Each (token, k) pair's destination rank and local expert (-1 for a
    dropped pair)."""
    flat_e = e_idx.reshape(-1).to(torch.int32)
    valid = keep.reshape(-1)
    none = torch.full_like(flat_e, -1)
    return (torch.where(valid, flat_e // e_local, none),
            torch.where(valid, flat_e % e_local, none))


def _compact(recv_el: torch.Tensor, e_local: int, c_pad: int):
    """Receiver-side compaction (``moe_a2a.py:173-184``): each received
    row's arrival-order slot in its local expert. Returns ``(rowid [wb]
    int32, inv [e_local*c_pad] int64, counts [e_local] int32, validr
    [wb])``: ``rowid`` the expert-major row of each received row
    (``e_local*c_pad`` for none), ``inv`` the received row of each
    expert-major row (``wb`` for none)."""
    wb = recv_el.shape[0]
    dev = recv_el.device
    validr = recv_el >= 0
    el = recv_el.clamp(min=0).long()
    onehot = (recv_el[None, :] == torch.arange(
        e_local, dtype=torch.int32, device=dev)[:, None]).to(torch.int32)
    cum = torch.cumsum(onehot, dim=1, dtype=torch.int32)     # [e_local, wb]
    posr = cum.gather(0, el.clamp(max=e_local - 1)[None, :])[0] - 1
    rows = e_local * c_pad
    rowid = torch.where(validr, el.to(torch.int32) * c_pad + posr,
                        torch.full_like(posr, rows))
    order = torch.arange(wb, device=dev)
    target = torch.where(validr, rowid.long(), rows + order)
    inv = torch.full((rows + wb,), wb, dtype=torch.long, device=dev)
    inv = inv.scatter_(0, target, order)[:rows]
    return rowid, inv, onehot.sum(dim=1, dtype=torch.int32), validr


def _gather_live(src: torch.Tensor, idx: torch.Tensor, bound: int):
    """Rows ``src[idx]`` where ``idx < bound``, zero elsewhere."""
    live = idx < bound
    return F.embedding(torch.where(live, idx, torch.zeros_like(idx)), src) \
        * live.to(src.dtype)[:, None]


def dispatch_local(tok, e_idx, keep, *, num_experts: int, ep: int, group,
                   c_pad: int, bucket: int):
    """Per-rank half of the a2a dispatch (``moe_a2a.py:142-184``).

    ``tok [n_l, M]`` this rank's token rows; ``e_idx``/``keep [n_l, K]``
    the GLOBAL routing of those rows. Packs each kept (token, k) pair
    toward the rank owning its expert, exchanges, and compacts the
    received rows expert-major. Returns ``(x_buf [E_local*c_pad, M],
    counts [E_local] int32, state)``; ``state`` is what
    :func:`combine_local` needs to send the outputs back."""
    k = e_idx.shape[1]
    e_local = num_experts // ep
    dest, el = _pairs(e_idx, keep, e_local)
    x_pairs = tok.repeat_interleave(k, dim=0)       # pair p = token p // K
    recv_x, recv_el, send_pos = coll.ragged_all_to_all(
        x_pairs, dest, bucket=bucket, group=group, world=ep, meta=el)
    rowid, inv, counts, validr = _compact(recv_el, e_local, c_pad)
    x_buf = _gather_live(recv_x, inv, recv_x.shape[0])
    return x_buf, counts, (send_pos, rowid, validr)


def combine_local(y_buf, state, w, keep, *, group, ep: int):
    """Mirror of :func:`dispatch_local` (``moe_a2a.py:187-197``): expert
    outputs ride the packed slots back to their source ranks, then each
    token sums its K expert rows with the gate weights, in
    ``sorted_combine``'s order (the bitwise-parity contract)."""
    send_pos, rowid, _ = state
    y_send = _gather_live(y_buf, rowid.long(), y_buf.shape[0])
    y_back = coll.ragged_all_to_all(y_send, group=group, world=ep)
    got = send_pos >= 0
    rows = F.embedding(torch.where(got, send_pos,
                                   torch.zeros_like(send_pos)).long(), y_back)
    wk = (w.reshape(-1).to(y_buf.dtype) * keep.reshape(-1).to(y_buf.dtype))
    n_l, k = w.shape
    return (rows * wk[:, None]).reshape(n_l, k, -1).sum(dim=1)


def _pack_for_fused(tok, e_idx, keep, *, num_experts: int, ep: int, group,
                    c_pad: int, bucket: int):
    """The dispatch packing without the payload exchange, for the fused
    kernel (``moe_a2a.py:205-252``): only the int32 expert ids ride an
    exchange here. Returns the send buffer, the receiver-side gather
    permutation, the per-expert counts and the same combine ``state`` as
    :func:`dispatch_local`."""
    k = e_idx.shape[1]
    e_local = num_experts // ep
    dest, el = _pairs(e_idx, keep, e_local)
    x_pairs = tok.repeat_interleave(k, dim=0)
    npair = dest.shape[0]
    send_pos, inv_s = coll.pack_positions(dest, ep, bucket)
    x_send = _gather_live(x_pairs, inv_s, npair)
    lives = inv_s < npair
    el_send = torch.where(lives, el[torch.where(lives, inv_s,
                                                torch.zeros_like(inv_s))],
                          torch.full_like(inv_s, -1, dtype=torch.int32))
    recv_el = coll._tiled_exchange(el_send.to(torch.int32), group)
    rowid, inv, counts, validr = _compact(recv_el, e_local, c_pad)
    return x_send, inv.to(torch.int32), counts, (send_pos, rowid, validr)


def _exchange_mlp_reference(x_send, counts, inv, g, u, d, *, group,
                            ep: int, chunks: int, bucket: int, c_pad: int):
    """The composed form of the fused kernel (``moe_a2a.py:267-280``),
    differentiable: per chunk the tiled exchange (#15 on CUDA), the
    ``inv`` gather and the grouped-GEMM expert MLP (#11-13 on CUDA)."""
    e_local = counts.shape[0] // chunks
    wb, rows = ep * bucket, e_local * c_pad
    ys = []
    for c in range(chunks):
        recv = coll.ragged_all_to_all(x_send[c * wb:(c + 1) * wb],
                                      group=group, world=ep)
        xb = _gather_live(recv, inv[c * rows:(c + 1) * rows].long(), wb)
        ys.append(gg.expert_mlp(xb, counts[c * e_local:(c + 1) * e_local],
                                g, u, d))
    return ys[0] if chunks == 1 else torch.cat(ys)


class _FusedExchangeMlp(torch.autograd.Function):
    """Every chunk's exchange and expert MLP in one launch of #17
    (``moe_a2a.py:255-308``). The reference has no backward kernel: the
    backward differentiates the composed reference, whose math is the
    kernel's row for row (#15 for the exchange's transpose, #11-13 for the
    expert MLP)."""

    @staticmethod
    def forward(ctx, x_send, counts, inv, g, u, d, plan):
        ctx.save_for_backward(x_send, counts, inv, g, u, d)
        ctx.plan = plan
        return hops.fused_a2a_expert_mlp(
            x_send, counts, inv, g, u, d, group=plan.group,
            chunks=plan.chunks, bucket=plan.bucket, c_pad=plan.c_pad)

    @staticmethod
    def backward(ctx, dy):
        x_send, counts, inv, g, u, d = ctx.saved_tensors
        p = ctx.plan
        leaves = [t.detach().requires_grad_(True) for t in (x_send, g, u, d)]
        with torch.enable_grad():
            y = _exchange_mlp_reference(
                leaves[0], counts, inv, *leaves[1:], group=p.group, ep=p.ep,
                chunks=p.chunks, bucket=p.bucket, c_pad=p.c_pad)
        dx, dg, du, dd = torch.autograd.grad(y, leaves, dy.to(y.dtype))
        return dx, None, None, dg, du, dd, None


@dataclass(frozen=True)
class _Plan:
    group: object
    ep: int
    idx: int            # this rank's coordinate on the ep axis
    num_e: int
    e_local: int
    n_l: int
    c_pad: int
    chunks: int
    bucket: int
    fused: bool
    full: bool          # the layer holds all E experts (slice, gather dW)
    remat: bool = False     # recompute the composed expert MLP backward


def _plan(mesh, ep_axis: str, num_e: int, n: int, k: int, capacity: int,
          full: bool = False, chunks: Optional[int] = None,
          remat: bool = False) -> _Plan:
    """The static sizes of the rank's half (``moe_a2a.py:327-350``): ``n``
    global tokens routed top-``k`` at ``capacity``; ``chunks`` from
    ``moe_a2a_overlap``/``moe_a2a_chunks`` unless given, clamped to the
    largest divisor of the rank's rows."""
    ep = mesh.get_dim_size(ep_axis)
    e_local, n_l = num_e // ep, n // ep
    c_pad = gg.padded_capacity(capacity)
    if chunks is None:
        chunks = 1
        if bool(flags.flag("moe_a2a_overlap")):
            chunks = max(1, int(flags.flag("moe_a2a_chunks")))
    while n_l % chunks:             # largest divisor <= requested
        chunks -= 1
    return _Plan(group=mesh.group(ep_axis), ep=ep,
                 idx=mesh.axis_index(ep_axis), num_e=num_e, e_local=e_local,
                 n_l=n_l, c_pad=c_pad, chunks=chunks,
                 bucket=min(n_l // chunks * k, e_local * c_pad),
                 fused=hops.fused_kernel_enabled(), full=full, remat=remat)


def _pack_chunks(tok, e_idx, keep, p: _Plan):
    """Every chunk of the rank's rows packed for the fused kernel:
    ``(x_send, counts, inv, states)``, chunk-major."""
    nc = p.n_l // p.chunks
    packs = [_pack_for_fused(
        tok[c * nc:(c + 1) * nc], e_idx[c * nc:(c + 1) * nc],
        keep[c * nc:(c + 1) * nc], num_experts=p.num_e, ep=p.ep,
        group=p.group, c_pad=p.c_pad, bucket=p.bucket)
        for c in range(p.chunks)]
    return (torch.cat([x[0] for x in packs]), torch.cat([x[2] for x in packs]),
            torch.cat([x[1] for x in packs]), [x[3] for x in packs])


def _local_forward(tok, e_idx, w, keep, wg, wu, wd, p: _Plan):
    """The reference's shard_map body (``moe_a2a.py:368-428``) on this
    rank's rows and local experts."""
    nc = p.n_l // p.chunks
    part = [slice(c * nc, (c + 1) * nc) for c in range(p.chunks)]
    ys = []
    if p.fused:
        x_send, counts, inv, states = _pack_chunks(tok, e_idx, keep, p)
        y_all = _FusedExchangeMlp.apply(x_send, counts, inv, wg, wu, wd, p)
        rows = p.e_local * p.c_pad
        for c, s in enumerate(part):
            ys.append(combine_local(y_all[c * rows:(c + 1) * rows],
                                    states[c], w[s], keep[s], group=p.group,
                                    ep=p.ep))
    else:
        kw = dict(num_experts=p.num_e, ep=p.ep, group=p.group,
                  c_pad=p.c_pad, bucket=p.bucket)
        nxt = dispatch_local(tok[part[0]], e_idx[part[0]], keep[part[0]],
                             **kw)
        for c, s in enumerate(part):
            cur = nxt
            if c + 1 < p.chunks:
                # chunk c+1's exchange is issued before chunk c's GEMMs
                s1 = part[c + 1]
                nxt = dispatch_local(tok[s1], e_idx[s1], keep[s1], **kw)
            x_buf, cnts, st = cur
            # the reference's jax.checkpoint(experts_fn) under remat
            y_buf = (checkpoint(gg.expert_mlp, x_buf, cnts, wg, wu, wd,
                                use_reentrant=False) if p.remat
                     else gg.expert_mlp(x_buf, cnts, wg, wu, wd))
            ys.append(combine_local(y_buf, st, w[s], keep[s], group=p.group,
                                    ep=p.ep))
    return ys[0] if p.chunks == 1 else torch.cat(ys)


class _A2AGrouped(torch.autograd.Function):
    """Global tokens and routing in, global output out, on every rank of
    the ep group; the exchange runs on the rank's rows. The backward
    differentiates the rank's half (its collectives in program order, the
    same on every rank) and all-gathers the tokens' and the routing
    weights' gradients, and, for a layer holding all E experts, the
    experts' gradients."""

    @staticmethod
    def forward(ctx, tokens, w, wg, wu, wd, e_idx, keep, p):
        rows = slice(p.idx * p.n_l, (p.idx + 1) * p.n_l)
        blk = slice(p.idx * p.e_local, (p.idx + 1) * p.e_local)
        leaves = [tokens[rows], w[rows]] + [x[blk] if p.full else x
                                            for x in (wg, wu, wd)]
        need = any(ctx.needs_input_grad[:5])
        leaves = [x.detach().requires_grad_(need) for x in leaves]
        with torch.enable_grad():
            y_l = _local_forward(leaves[0], e_idx[rows], leaves[1],
                                 keep[rows], *leaves[2:], p)
        ctx.plan = p
        ctx.inner = (y_l, leaves) if need else None
        return coll.all_gather(y_l.detach(), p.group, axis=0)

    @staticmethod
    def backward(ctx, dy):
        p = ctx.plan
        y_l, leaves = ctx.inner
        ctx.inner = None
        dy_l = dy[p.idx * p.n_l:(p.idx + 1) * p.n_l].to(y_l.dtype)
        grads = list(torch.autograd.grad(y_l, leaves, dy_l.contiguous()))
        grads[0] = coll.all_gather(grads[0].contiguous(), p.group, axis=0)
        grads[1] = coll.all_gather(grads[1].contiguous(), p.group, axis=0)
        if p.full:
            grads[2:] = [coll.all_gather(g.contiguous(), p.group, axis=0)
                         for g in grads[2:]]
        return (*grads, None, None, None)


def a2a_grouped_forward(tokens, routed, wg, wu, wd, capacity, mesh,
                        ep_axis, shape, ct, num_experts: Optional[int] = None,
                        remat: bool = False):
    """The ep > 1 grouped forward (``moe_a2a.py:311-447``): global routing
    -> this rank's ragged a2a dispatch -> its local experts -> the mirrored
    combine, then the global output. ``wg``/``wu``/``wd`` are the layer's
    stacked leaves: this rank's ``E/ep`` experts (``shard_experts``) or all
    ``E`` (``num_experts``), of which it runs its block. ``remat``
    recomputes the composed route's expert MLP in the backward (the fused
    route saves only its inputs already). Returns ``(y in shape[:-1] +
    (M,), aux)``."""
    require_ep_only(mesh, ep_axis, "the MoE a2a dispatch")
    e_idx, _, w, keep, aux = routed
    num_e = num_experts if num_experts is not None else wg.shape[0]
    e_local = num_e // mesh.get_dim_size(ep_axis)
    if wg.shape[0] not in (num_e, e_local):
        raise ValueError(f"stacked experts {wg.shape[0]}: neither all "
                         f"{num_e} nor this rank's {e_local}")
    plan = _plan(mesh, ep_axis, num_e, tokens.shape[0], e_idx.shape[1],
                 capacity, full=wg.shape[0] == num_e, remat=remat)
    y = _A2AGrouped.apply(tokens.to(ct), w, wg.to(ct), wu.to(ct), wd.to(ct),
                          e_idx, keep, plan)
    return y.reshape(tuple(shape[:-1]) + (y.shape[-1],)), aux.float()
