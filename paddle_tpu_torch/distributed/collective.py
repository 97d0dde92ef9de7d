"""The collectives the context-parallel ring uses (the part of
``paddle_tpu/distributed/collective.py`` that the ring reaches; the rest
is ROADMAP.md A.10).

Each takes a ``torch.distributed`` group (a mesh axis's group, from
:meth:`ProcessMesh.group`; None is the default group). Two routes:

* an NCCL group moves CUDA tensors as they are;
* a gloo group moves host tensors: a CUDA tensor is copied to the host
  (a blocking copy, which waits for the kernels that wrote it), exchanged
  and copied back to its device. This is how ranks that share one card
  talk, since NCCL refuses two ranks on one GPU.

Any other pairing (a CPU tensor on NCCL, another backend) raises. In a
world of one rank (no process group) each collective is the identity on
its one participant.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["ppermute", "all_gather", "barrier"]


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
        return tensor.device.type == "cuda"
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
        dist.barrier(group=group)
