"""The collectives of the context-parallel ring and of the expert-parallel
MoE dispatch (the part of ``paddle_tpu/distributed/collective.py`` that
those paths reach; the rest is ROADMAP.md A.10).

Each takes a ``torch.distributed`` group (a mesh axis's group, from
:meth:`ProcessMesh.group`; None is the default group). Two routes:

* an NCCL group moves CUDA tensors as they are;
* a gloo group moves host tensors: a CUDA tensor is copied to the host
  (a blocking copy, which waits for the kernels that wrote it), exchanged
  and copied back to its device. This is how ranks that share one card
  talk, since NCCL refuses two ranks on one GPU. A ``jit.to_static``
  step that stages a collective so, or calls ``barrier``, runs eagerly.

Any other pairing (a CPU tensor on NCCL, another backend) raises. In a
world of one rank (no process group) each collective is the identity on
its one participant.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from paddle_tpu_torch.jit import api as _jit
from paddle_tpu_torch.ops.kernels import async_collectives as hops

__all__ = ["ppermute", "all_gather", "barrier", "all_to_all",
           "tiled_all_to_all", "ragged_all_to_all"]


def _route(tensor: torch.Tensor, group, what: str) -> bool:
    """True when the tensor must be staged through the host (gloo)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if tensor.device.type != "cuda":
            raise ValueError(f"{what}: the nccl backend moves CUDA tensors, "
                             f"got one on {tensor.device}")
        return False
    if backend == "gloo":
        if tensor.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what}: the gloo route moves CPU and CUDA "
                             f"tensors, got one on {tensor.device}")
        if tensor.device.type == "cuda":
            _jit.uncapturable(f"the gloo host-staged {what} "
                              f"(distributed/collective.py)")
            return True
        return False
    raise ValueError(f"{what}: backend {backend!r} is not routed (nccl or "
                     f"gloo)")


def _world(group) -> Tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def ppermute(tensor: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """``jax.lax.ppermute`` over ``group``: ``perm`` lists ``(src, dst)``
    pairs of group ranks; this rank sends ``tensor`` to its ``dst`` and
    returns what its ``src`` sent (zeros when nobody sends to it). The
    send and the receive go out as one ``batch_isend_irecv``, so a ring
    of hops cannot deadlock."""
    me, n = _world(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if n == 1 or (dst == [me] and src == [me]):
        return tensor.clone() if src else torch.zeros_like(tensor)
    staged = _route(tensor, group, "ppermute")
    world = dist.group.WORLD if group is None else group
    send = tensor.contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(world, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(world, src[0]), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not src:
        recv.zero_()
    return recv.to(tensor.device) if staged else recv


def all_gather(tensor: torch.Tensor, group=None, axis: int = 0
               ) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: every group rank's
    ``tensor`` concatenated along ``axis`` in group-rank order."""
    _, n = _world(group)
    if n == 1:
        return tensor
    staged = _route(tensor, group, "all_gather")
    send = tensor.contiguous()
    if staged:
        send = send.cpu()
    parts: List[torch.Tensor] = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=axis)
    return out.to(tensor.device) if staged else out


def barrier(group=None) -> None:
    if dist.is_initialized():
        _jit.uncapturable("a barrier (distributed/collective.py)")
        dist.barrier(group=group)


def tiled_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)``
    through the group's backend: row block ``j`` of ``x`` lands as block
    ``rank`` on rank ``j``. The blocks cross as raw bytes, so any dtype
    moves. This is the twin of the tiled all-to-all kernel and, on CPU
    tensors, the route of ``pallas_async_a2a=off``."""
    _, n = _world(group)
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"all_to_all: {tuple(x.shape)} does not split into "
                         f"{n} equal row blocks")
    if n == 1:
        return x.clone()
    staged = _route(x, group, "all_to_all")
    send = x.contiguous()
    if staged:
        send = send.cpu()
    raw = send.reshape(-1).view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=group)
    out = out.view(x.dtype).reshape(x.shape)
    return out.to(x.device) if staged else out


def all_to_all(out_tensor_list, in_tensor_list=None, group=None,
               sync_op: bool = True):
    """The reference's list form (``collective.py:357-400``): this rank's
    ``in_tensor_list[j]`` goes to rank ``j``, and ``out_tensor_list`` is
    filled with what each rank sent here, in rank order. The exchange is
    equal-block, so the inputs are validated first. The single-tensor form
    reshards a placed tensor, which waits for placements (ROADMAP.md
    A.10)."""
    if isinstance(out_tensor_list, torch.Tensor):
        raise NotImplementedError(
            "all_to_all(tensor) reshards a placed tensor; placements are not "
            "ported yet (ROADMAP.md A.10)")
    ins = in_tensor_list
    _, n = _world(group)
    if ins is None or len(ins) != n:
        raise ValueError(
            f"all_to_all(list) needs exactly one input tensor per rank: "
            f"got {0 if ins is None else len(ins)} for a group of {n}")
    shapes = [tuple(t.shape) for t in ins]
    if len(set(shapes)) != 1:
        raise ValueError(
            f"all_to_all(list): uneven split sizes {shapes} — the "
            f"exchange moves equal blocks. Pad every tensor to a common "
            f"shape, or use ragged_all_to_all for variable per-destination "
            f"row counts")
    stacked = torch.stack([t.contiguous() for t in ins])
    parts = _tiled_exchange(stacked, group).unbind(0)
    out_tensor_list.clear()
    out_tensor_list.extend(parts)
    return out_tensor_list


# ------------------------------------------------------ ragged all-to-all
def _tiled_exchange(x: torch.Tensor, group) -> torch.Tensor:
    """The square exchange (``collective.py:403-417``): the tiled
    all-to-all kernel (#15) when ``pallas_async_a2a`` is on (its twin on
    CPU tensors). ``off`` takes the backend's exchange on CPU tensors and
    raises on any other: on the card the exchange is the kernel's."""
    if hops.async_a2a_enabled():
        return hops.tiled_a2a(x.contiguous(), group)
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"pallas_async_a2a=off: the collective exchange moves CPU "
            f"tensors; a tensor on {x.device} goes through the tiled "
            f"all-to-all kernel ('auto' or 'on')")
    return tiled_all_to_all(x, group)


class _TiledA2A(torch.autograd.Function):
    """The bucketed square exchange, differentiable: ``recv_i[j] =
    send_j[i]``, so the exchange is its own adjoint and the backward is
    the same exchange of the cotangent (``collective.py:420-437``), the
    property the MoE combine relies on."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _tiled_exchange(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _tiled_exchange(dy, ctx.group), None


def pack_positions(dest: torch.Tensor, world: int, bucket: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(send_pos [n] int32, inv [world*bucket] int64)`` of the bucketed
    pack: row ``p`` with ``dest[p] >= 0`` takes the next slot of its
    destination's bucket (arrival order, an int32 cumsum along the
    contiguous dim) unless the bucket is full; ``send_pos`` is its packed
    row (-1: dropped), ``inv`` the row packed into each slot (``n``: none).
    The inverse permutation is one scatter whose targets are all distinct
    (each dropped row gets its own place past the buffer), so it is
    deterministic on the card."""
    n = dest.shape[0]
    rows = world * bucket
    dest = dest.to(torch.int32)
    valid = dest >= 0
    onehot = (dest[None, :] == torch.arange(
        world, dtype=torch.int32, device=dest.device)[:, None]).to(torch.int32)
    cum = torch.cumsum(onehot, dim=1, dtype=torch.int32)       # [world, n]
    pos = cum.gather(0, dest.clamp(0, world - 1).long()[None, :])[0] - 1
    fits = valid & (pos < bucket)
    send_pos = torch.where(fits, dest * bucket + pos,
                           torch.full_like(dest, -1))
    order = torch.arange(n, device=dest.device)
    target = torch.where(fits, send_pos.long(), rows + order)
    inv = torch.full((rows + n,), n, dtype=torch.long, device=dest.device)
    inv = inv.scatter_(0, target, order)[:rows]
    return send_pos, inv


def ragged_all_to_all(x: torch.Tensor, dest: Optional[torch.Tensor] = None,
                      *, bucket: Optional[int] = None, group=None,
                      world: Optional[int] = None,
                      meta: Optional[torch.Tensor] = None):
    """Capacity-bucketed ragged all-to-all (``collective.py:462-540``).

    Each rank owns ``x [n, ...]`` rows plus ``dest [n]`` destination ranks
    of ``group`` (negative = drop). Rows are packed into ``bucket`` static
    slots per destination (a destination past ``bucket`` rows drops the
    rest; the caller sizes ``bucket`` so that none does) and exchanged
    with one tiled all-to-all, so each rank sends ``world * bucket`` rows.
    Returns ``(recv, recv_meta, send_pos)``:

    * ``recv [world*bucket, ...]``: block ``j`` holds the rows rank ``j``
      sent here, in send order; unused slots are zero;
    * ``recv_meta [world*bucket]`` int32: the rows' ``meta`` values (-1 in
      unused slots), or None when ``meta`` is None;
    * ``send_pos [n]`` int32: the packed slot each local row landed in (-1:
      dropped), the gather key of the mirrored return exchange.

    With ``dest=None``, ``x`` is already a packed ``[world*bucket, ...]``
    buffer and the call is the pure exchange (the return direction); only
    ``recv`` is returned. Differentiable in ``x``: the backward runs the
    mirrored exchange. Collective over ``group``."""
    w = int(world) if world is not None else _world(group)[1]
    if dest is None:
        if x.shape[0] % w:
            raise ValueError(
                f"ragged_all_to_all(dest=None): packed buffer rows "
                f"{x.shape[0]} not a multiple of the axis size {w}")
        return _TiledA2A.apply(x, group)
    if bucket is None or bucket < 1:
        raise ValueError("ragged_all_to_all: packing mode needs a positive "
                         "static bucket size")
    n = x.shape[0]
    send_pos, inv = pack_positions(dest, w, bucket)
    live = inv < n
    src = torch.where(live, inv, torch.zeros_like(inv))
    flat = x.reshape(n, -1)
    x_send = (F.embedding(src, flat) * live.to(x.dtype)[:, None]).reshape(
        (w * bucket,) + tuple(x.shape[1:]))
    recv = _TiledA2A.apply(x_send, group)
    recv_meta = None
    if meta is not None:      # ints carry no tangent: a plain exchange
        m_send = torch.where(live, meta.to(torch.int32)[src],
                             torch.full_like(src, -1, dtype=torch.int32))
        recv_meta = _tiled_exchange(m_send, group)
    return recv, recv_meta, send_pos
