"""The ring-attention KV hop: the kernel ``csrc/async_collectives.cu`` and
its plain twin.

Port of ``paddle_tpu/ops/pallas/async_collectives.py:ring_kv_rotate``
(the remote-DMA pair kernel that moves K and V one hop round the ring).
The rest of that module (``tiled_a2a``, ``fused_a2a_expert_mlp``) is
ROADMAP.md B.7.

On CUDA tensors the hop goes device to device through CUDA IPC between
the ranks of one host (see the source for the protocol): each rank stages
its pair into an exported slot, the group meets at a barrier, and each
rank pulls its source's slot. Ranks on one card share it through the
mapping; ranks on other cards of the host read over NVLink. CPU tensors
take the twin, the reference's own route off the TPU: one stacked
``ppermute`` (``paddle_tpu/distributed/sequence_parallel.py:287-296``).
"""

from __future__ import annotations

import ctypes
import socket
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["ring_kv_rotate", "ring_kv_rotate_plain", "release", "launches"]

#: copy-kernel launches made by :func:`ring_kv_rotate` (two a hop: stage
#: and pull; never by the plain twin)
launches = 0

_ALIGN = 256           # byte alignment of the second segment in a slot
_GRAIN = 1 << 20       # slots grow in whole MiB


def ring_kv_rotate_plain(k: torch.Tensor, v: torch.Tensor,
                         perm: Sequence[Tuple[int, int]], group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hop as one stacked ``ppermute`` (K and V share a shape)."""
    from paddle_tpu_torch.distributed import collective
    kv = collective.ppermute(torch.stack([k, v]), perm, group)
    return kv[0], kv[1]


class _Ring:
    """One group's exported buffer (two slots of ``cap`` bytes) and the
    peers' buffers mapped into this process."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.cap, self.base, self.slot = 0, None, 0
        self.handles, self.peers = [], {}

    def _quiesce(self) -> None:
        """Every rank's kernels on the buffers have finished."""
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)

    def _drop(self) -> None:
        dev = self.device.index
        for ptr in self.peers.values():
            _launch.launch("ptt_ipc_close", dev, ptr)
        self.peers = {}
        dist.barrier(group=self.group)   # no peer maps our buffer now
        if self.base is not None:
            _launch.launch("ptt_ipc_free", dev, self.base)
        self.base, self.cap = None, 0

    def reserve(self, nbytes: int) -> None:
        """Grow both slots to ``nbytes`` (collective: every rank of the
        group asks for the same size at the same hop)."""
        if nbytes <= self.cap:
            return
        self._quiesce()
        self._drop()
        cap = -(-nbytes // _GRAIN) * _GRAIN
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        _launch.launch("ptt_ipc_alloc", self.device.index, 2 * cap,
                       ctypes.byref(ptr), handle)
        self.base, self.cap = ptr.value, cap
        mine = (handle.raw, socket.gethostname())
        world = dist.get_world_size(self.group)
        got = [None] * world
        dist.all_gather_object(got, mine, group=self.group)
        hosts = {h for _, h in got}
        if len(hosts) != 1:
            raise RuntimeError(f"ring_kv_rotate: the IPC hop joins ranks of "
                               f"one host, this group spans {sorted(hosts)}")
        self.handles = [h for h, _ in got]

    def peer(self, rank: int) -> int:
        if rank not in self.peers:
            ptr = ctypes.c_void_p()
            _launch.launch("ptt_ipc_open", self.device.index,
                           self.handles[rank], ctypes.byref(ptr))
            self.peers[rank] = ptr.value
        return self.peers[rank]

    def release(self) -> None:
        self._quiesce()
        self._drop()


_rings: Dict[object, _Ring] = {}


def _copy(src0: int, dst0: int, src1: int, dst1: int, nbytes: int,
          stream: int) -> None:
    global launches
    _launch.launch("ptt_ring_copy", src0, dst0, nbytes, src1, dst1, nbytes,
                   2, stream)
    launches += 1


def ring_kv_rotate(k: torch.Tensor, v: torch.Tensor,
                   perm: Sequence[Tuple[int, int]], group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move the pair ``(k, v)`` one hop round ``group``: ``perm`` lists
    ``(src, dst)`` group ranks and must send from and to every rank (a
    ring). Returns what this rank's source sent. Collective: every rank of
    the group calls it with tensors of the same shapes and dtypes. CPU
    tensors take :func:`ring_kv_rotate_plain`; CUDA tensors launch
    ``ptt_ring_copy`` twice."""
    if k.device.type == "cpu" and v.device.type == "cpu":
        return ring_kv_rotate_plain(k, v, perm, group)
    dev = _launch.check_cuda("ring_kv_rotate", k, v)
    _launch.require(k.shape == v.shape and k.dtype == v.dtype,
                    "ring_kv_rotate: k and v must share a shape and dtype")
    group = dist.group.WORLD if group is None else group
    me, world = dist.get_rank(group), dist.get_world_size(group)
    src = [s for s, d in perm if d == me]
    _launch.require(sorted(s for s, _ in perm) == list(range(world))
                    and sorted(d for _, d in perm) == list(range(world)),
                    f"ring_kv_rotate: {list(perm)} does not send from and to "
                    f"every one of the group's {world} ranks")
    ring = _rings.get(group)
    if ring is None:
        ring = _rings[group] = _Ring(group, dev)
    nbytes = k.numel() * k.element_size()
    off = -(-nbytes // _ALIGN) * _ALIGN
    ring.reserve(off + nbytes)
    s, ring.slot = ring.slot, ring.slot ^ 1
    stream = _launch.stream_of(dev)
    mine = ring.base + s * ring.cap
    _copy(k.data_ptr(), mine, v.data_ptr(), mine + off, nbytes, stream)
    ring._quiesce()                     # every rank's slot s is staged
    theirs = ring.peer(src[0]) + s * ring.cap if src[0] != me else mine
    ko, vo = torch.empty_like(k), torch.empty_like(v)
    _copy(theirs, ko.data_ptr(), theirs + off, vo.data_ptr(), nbytes, stream)
    return ko, vo


def release() -> None:
    """Free every group's buffers (collective over each group, in the
    order the groups first hopped, which is the same on every rank)."""
    for ring in list(_rings.values()):
        ring.release()
    _rings.clear()
