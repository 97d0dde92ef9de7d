"""Exchanges between the ranks of one host: the kernels of
``csrc/async_collectives.cu`` and their plain twins.

Port of ``paddle_tpu/ops/pallas/async_collectives.py``, the remote-DMA
kernels of the TPU package:

* :func:`tiled_a2a` (#15, ``tiled_a2a`` :187): the square tiled
  all-to-all, row block ``j`` of ``x`` landing as block ``rank`` on rank
  ``j`` (``lax.all_to_all(tiled=True)``). Twin: the collective exchange
  (:func:`~paddle_tpu_torch.distributed.collective.tiled_all_to_all`).
* :func:`ring_kv_rotate` (#16, ``ring_kv_rotate`` :294): one hop of the
  ring-attention KV rotation. Twin: one stacked ``ppermute``.
* :func:`fused_a2a_expert_mlp` (#17, ``fused_a2a_expert_mlp`` :480): the
  chunked MoE dispatch exchange and the expert SwiGLU MLP in one call
  (bf16 where :func:`_fused_tma_ok` holds: a gate/up and a down kernel on
  ``wgmma``; fp32 and every other bf16 call: one kernel on the CUDA
  cores).
  Twin: the composed reference of ``moe_a2a.py:267-280`` (the exchange,
  the ``inv`` gather, the grouped-GEMM expert MLP).

On CUDA tensors every exchange goes device to device through CUDA IPC
between the ranks of one host (see the source for the protocol): each
rank stages what it sends into an exported slot, the group meets at a
barrier, and each rank reads its peers' slots. Ranks on one card share it
through the mapping; ranks on other cards of the host read over NVLink.
All three share one pair of slots per group, so the slot discipline holds
across mixed calls. CPU tensors take the twins.
"""

from __future__ import annotations

import ctypes
import socket
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from paddle_tpu_torch import flags
from paddle_tpu_torch.jit import api as _jit
from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["async_a2a_enabled", "fused_kernel_enabled", "tiled_a2a",
           "tiled_a2a_plain", "ring_kv_rotate", "ring_kv_rotate_plain",
           "fused_a2a_expert_mlp", "fused_a2a_expert_mlp_plain",
           "tiled_a2a_pull", "ring_kv_pull", "fused_a2a_expert_mlp_pull",
           "release",
           "launches", "launches_a2a", "launches_fused", "MAX_PEERS"]

#: copy-kernel launches made by :func:`ring_kv_rotate` (two a hop: stage
#: and pull; never by the plain twin)
launches = 0
#: pull-kernel launches made by :func:`tiled_a2a` (one an exchange; the
#: stage into the slot is the exchange protocol's copy, not #15's kernel)
launches_a2a = 0
#: fused-kernel calls made by :func:`fused_a2a_expert_mlp` (one a call: in
#: bf16 its gate/up and down launches together)
launches_fused = 0

#: ranks one exchange can join (``kMaxSeg`` in the .cu)
MAX_PEERS = 8
_ALIGN = 256           # byte alignment of each segment in a slot
_GRAIN = 1 << 20       # slots grow in whole MiB


def _mode(name: str) -> str:
    mode = str(flags.flag(name)).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{name} must be 'auto', 'on' or 'off', got "
                         f"{mode!r}")
    return mode


def async_a2a_enabled() -> bool:
    """``pallas_async_a2a``: ``auto`` and its alias ``on`` take
    :func:`tiled_a2a` (the kernel on CUDA tensors, its twin on CPU
    tensors); ``off`` the collective exchange, the reference's
    ``lax.all_to_all``, which the caller allows on CPU tensors only."""
    return _mode("pallas_async_a2a") != "off"


def fused_kernel_enabled() -> bool:
    """``moe_a2a_fused_kernel``: ``auto`` and its alias ``on`` take
    :func:`fused_a2a_expert_mlp` at any chunk count; ``off`` the composed
    pipelined path."""
    return _mode("moe_a2a_fused_kernel") != "off"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Ring:
    """One group's exported buffer (two slots of ``cap`` bytes) and the
    peers' buffers mapped into this process, shared by every exchange of
    the group."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.rank = dist.get_rank(group)      # this process's group rank
        self.cap, self.base, self.slot = 0, None, 0
        self.handles, self.peers = [], {}

    def _quiesce(self) -> None:
        """Every rank's kernels on the buffers have finished (a host
        sync and a barrier: a ``jit.to_static`` step that gets here runs
        eagerly)."""
        _jit.uncapturable("the exchange's synchronize and barrier "
                          "(ops/kernels/async_collectives.py)")
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
        group asks for the same size at the same exchange)."""
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
            raise RuntimeError(f"the IPC exchange joins ranks of one host, "
                               f"this group spans {sorted(hosts)}")
        self.handles = [h for h, _ in got]

    def stage(self, tensors: Sequence[torch.Tensor], stream: int
              ) -> Tuple[int, List[int], int]:
        """Copy ``tensors`` (contiguous, any number) into this rank's next
        slot, each at a ``_ALIGN``-byte offset, then wait until every rank
        of the group has staged. Collective. Returns the slot, the offsets
        and the number of copy launches made (two segments a launch)."""
        offs, total = [], 0
        for t in tensors:
            offs.append(total)
            total += -(-_nbytes(t) // _ALIGN) * _ALIGN
        self.reserve(total)
        s, self.slot = self.slot, self.slot ^ 1
        mine = self.base + s * self.cap
        segs = [(t.data_ptr(), mine + o, _nbytes(t))
                for t, o in zip(tensors, offs)]
        made = 0
        for i in range(0, len(segs), 2):
            a = segs[i]
            b = segs[i + 1] if i + 1 < len(segs) else (None, None, 0)
            _launch.launch("ptt_ring_copy", a[0], a[1], a[2], b[0], b[1],
                           b[2], 2 if i + 1 < len(segs) else 1, stream)
            made += 1
        self._quiesce()
        return s, offs, made

    def addr(self, rank: int, s: int) -> int:
        """Group rank ``rank``'s slot ``s`` in this process's address
        space."""
        if rank == self.rank:
            return self.base + s * self.cap
        if rank not in self.peers:
            ptr = ctypes.c_void_p()
            _launch.launch("ptt_ipc_open", self.device.index,
                           self.handles[rank], ctypes.byref(ptr))
            self.peers[rank] = ptr.value
        return self.peers[rank] + s * self.cap

    def release(self) -> None:
        self._quiesce()
        self._drop()


_rings: Dict[object, _Ring] = {}


def _ring(group, dev: torch.device) -> _Ring:
    ring = _rings.get(group)
    if ring is None:
        ring = _rings[group] = _Ring(group, dev)
    return ring


def _group_of(what: str, group):
    """``(group, rank, world)``; a world of one without a process group."""
    if not dist.is_initialized():
        return None, 0, 1
    group = dist.group.WORLD if group is None else group
    me, world = dist.get_rank(group), dist.get_world_size(group)
    _launch.require(world <= MAX_PEERS, f"{what}: a group of {world} ranks; "
                    f"the exchange joins at most {MAX_PEERS}")
    return group, me, world


def _pointers(ptrs: Sequence[int]):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


# ------------------------------------------------------------ #15 tiled a2a
def tiled_a2a_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """The exchange through the group's backend (gloo moves host tensors,
    NCCL device tensors): ``lax.all_to_all(x, split_axis=0, concat_axis=0,
    tiled=True)``."""
    from paddle_tpu_torch.distributed import collective
    return collective.tiled_all_to_all(x, group)


def tiled_a2a(x: torch.Tensor, group=None) -> torch.Tensor:
    """Row block ``j`` of ``x [rows, ...]`` (``rows % world == 0``) lands as
    block ``rank`` on rank ``j`` of ``group``; returns the blocks this rank
    received, in rank order. Collective: every rank calls it with a tensor
    of the same shape and dtype. CPU tensors take :func:`tiled_a2a_plain`;
    CUDA tensors stage into the group's slot and launch ``ptt_a2a_pull``
    once."""
    if x.device.type == "cpu":
        return tiled_a2a_plain(x, group)
    dev, group, world = _a2a_args(x, group)
    s = None
    if world > 1:
        s, _, _ = _ring(group, dev).stage([x], _launch.stream_of(dev))
    return _a2a_pull(x, group, s)


def tiled_a2a_pull(x: torch.Tensor, group=None) -> torch.Tensor:
    """#15's pull alone, from the slot the group's last exchange staged: no
    stage and no barrier. That exchange must have been a
    :func:`tiled_a2a` of ``x`` on every rank, with no rank restaging
    since; it times the kernel apart from the exchange protocol. Returns
    what that :func:`tiled_a2a` returned."""
    _, group, world = _a2a_args(x, group)
    return _a2a_pull(x, group, None if world == 1 else _last_slot(group))


def _a2a_args(x, group):
    dev = _launch.check_cuda("tiled_a2a", x)
    group, _, world = _group_of("tiled_a2a", group)
    _launch.require(x.dim() >= 1 and x.shape[0] % world == 0,
                    f"tiled_a2a: {x.shape[0] if x.dim() else 0} rows do not "
                    f"split into {world} equal blocks")
    return dev, group, world


def _a2a_pull(x, group, s):
    """Launch ``ptt_a2a_pull`` once over the peers' slot ``s`` (None: a
    world of one, ``x`` itself)."""
    global launches_a2a
    dev = x.device
    _, me, world = _group_of("tiled_a2a", group)
    out = torch.empty_like(x)
    blk = _nbytes(x) // world
    if s is None:
        srcs = [x.data_ptr()]
    else:
        ring = _rings[group]
        srcs = [x.data_ptr() + me * blk if j == me
                else ring.addr(j, s) + me * blk for j in range(world)]
    _launch.launch("ptt_a2a_pull", _pointers(srcs), out.data_ptr(), blk,
                   world, me, _launch.stream_of(dev))
    launches_a2a += 1
    return out


def _last_slot(group) -> int:
    """The slot the group's last exchange staged."""
    ring = _rings.get(group)
    if ring is None:
        raise ValueError("no exchange of this group has staged a slot yet")
    return ring.slot ^ 1


# ------------------------------------------------------------ #16 ring hop
def ring_kv_rotate_plain(k: torch.Tensor, v: torch.Tensor,
                         perm: Sequence[Tuple[int, int]], group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hop as one stacked ``ppermute`` (K and V share a shape)."""
    from paddle_tpu_torch.distributed import collective
    kv = collective.ppermute(torch.stack([k, v]), perm, group)
    return kv[0], kv[1]


def ring_kv_rotate(k: torch.Tensor, v: torch.Tensor,
                   perm: Sequence[Tuple[int, int]], group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move the pair ``(k, v)`` one hop round ``group``: ``perm`` lists
    ``(src, dst)`` group ranks and must send from and to every rank (a
    ring). Returns what this rank's source sent. Collective: every rank of
    the group calls it with tensors of the same shapes and dtypes. CPU
    tensors take :func:`ring_kv_rotate_plain`; CUDA tensors launch
    ``ptt_ring_copy`` twice (stage and pull)."""
    global launches
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
    s, _, made = _ring(group, dev).stage([k, v], _launch.stream_of(dev))
    launches += made
    return _hop_pull(k, v, group, src[0], s)


def ring_kv_pull(k: torch.Tensor, v: torch.Tensor,
                 perm: Sequence[Tuple[int, int]], group=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """#16's pull alone, from the slot the group's last exchange staged: no
    stage and no barrier. That exchange must have been a
    :func:`ring_kv_rotate` of ``(k, v)`` over ``perm`` on every rank, with
    no rank restaging since; it times the kernel apart from the exchange
    protocol. Returns what that hop returned."""
    _launch.check_cuda("ring_kv_rotate", k, v)
    group = dist.group.WORLD if group is None else group
    s = _last_slot(group)
    me = _rings[group].rank
    src = [s_ for s_, d in perm if d == me]
    return _hop_pull(k, v, group, src[0], s)


def _hop_pull(k, v, group, src: int, s: int):
    """Launch ``ptt_ring_copy`` once: K and V from rank ``src``'s slot
    ``s`` (staged by ``_Ring.stage([k, v])``)."""
    global launches
    theirs = _rings[group].addr(src, s)
    nbytes = _nbytes(k)
    off = -(-nbytes // _ALIGN) * _ALIGN      # V's offset in the slot
    ko, vo = torch.empty_like(k), torch.empty_like(v)
    _launch.launch("ptt_ring_copy", theirs, ko.data_ptr(), nbytes,
                   theirs + off, vo.data_ptr(), nbytes, 2,
                   _launch.stream_of(k.device))
    launches += 1
    return ko, vo


# -------------------------------------------- #17 fused dispatch + experts
def fused_a2a_expert_mlp_plain(x_send, counts, inv, wg, wu, wd, *, group,
                               chunks: int, bucket: int, c_pad: int):
    """The composed reference (``moe_a2a.py:267-280``) on the twins: per
    chunk, the tiled exchange of the packed tiles, the expert-major gather
    through ``inv`` (sentinel rows zero) and the SwiGLU expert MLP."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    world = collective._world(group)[1]
    wb, e_local = world * bucket, wg.shape[0]
    rows = e_local * c_pad
    ys = []
    for c in range(chunks):
        recv = tiled_a2a_plain(x_send[c * wb:(c + 1) * wb], group)
        ic = inv[c * rows:(c + 1) * rows].long()
        live = ic < wb
        xb = F.embedding(torch.where(live, ic, torch.zeros_like(ic)), recv) \
            * live.to(recv.dtype)[:, None]
        ys.append(gg.expert_mlp(xb, counts[c * e_local:(c + 1) * e_local],
                                wg, wu, wd, plain=True))
    return ys[0] if chunks == 1 else torch.cat(ys)


def fused_a2a_expert_mlp(x_send: torch.Tensor, counts: torch.Tensor,
                         inv: torch.Tensor, wg: torch.Tensor,
                         wu: torch.Tensor, wd: torch.Tensor, *, group,
                         chunks: int, bucket: int, c_pad: int
                         ) -> torch.Tensor:
    """Every chunk's dispatch exchange and the experts' SwiGLU MLP in one
    call. ``x_send [chunks*world*bucket, M]``: this rank's packed tiles,
    chunk-major, destination block ``j`` of chunk ``c`` at rows ``(c*world
    + j)*bucket``; ``counts [chunks*e_local]`` int32 live rows per chunk and
    local expert; ``inv [chunks*e_local*c_pad]`` int32, each expert-major
    slot's row of its chunk's landing buffer (``world*bucket`` for none);
    ``wg``/``wu [e_local, M, F]``, ``wd [e_local, F, M]``. Returns ``y
    [chunks*e_local*c_pad, M]``, rows past each count zero. Collective.
    CPU tensors take :func:`fused_a2a_expert_mlp_plain`; CUDA tensors stage
    ``x_send`` into the group's slot and call ``ptt_fused_a2a_mlp`` once
    (one count of ``launches_fused``), which reads the peers' slots itself;
    the route is picked before the launch by :func:`_fused_tma_ok`."""
    if x_send.device.type == "cpu":
        return fused_a2a_expert_mlp_plain(x_send, counts, inv, wg, wu, wd,
                                          group=group, chunks=chunks,
                                          bucket=bucket, c_pad=c_pad)
    dev, group, world = _fused_args(x_send, counts, inv, wg, wu, wd, group,
                                    chunks, bucket, c_pad)
    s = None
    if world > 1:
        s, _, _ = _ring(group, dev).stage([x_send], _launch.stream_of(dev))
    return _fused_pull(x_send, counts, inv, wg, wu, wd, group, chunks,
                       bucket, c_pad, s)


def fused_a2a_expert_mlp_pull(x_send: torch.Tensor, counts: torch.Tensor,
                              inv: torch.Tensor, wg: torch.Tensor,
                              wu: torch.Tensor, wd: torch.Tensor, *, group,
                              chunks: int, bucket: int, c_pad: int
                              ) -> torch.Tensor:
    """#17's launch alone, reading the slot the group's last exchange
    staged: no stage and no barrier. That exchange must have been a
    :func:`fused_a2a_expert_mlp` of ``x_send`` on every rank, with no rank
    restaging since; it times the kernel apart from the exchange protocol.
    Returns what that call returned."""
    _, group, world = _fused_args(x_send, counts, inv, wg, wu, wd, group,
                                  chunks, bucket, c_pad)
    return _fused_pull(x_send, counts, inv, wg, wu, wd, group, chunks,
                       bucket, c_pad, None if world == 1 else _last_slot(group))


def _fused_args(x_send, counts, inv, wg, wu, wd, group, chunks, bucket,
                c_pad):
    what = "fused_a2a_expert_mlp"
    dev = _launch.check_cuda(what, x_send, counts, inv, wg, wu, wd)
    group, _, world = _group_of(what, group)
    e_local, m, ffn = wg.shape
    _launch.require(x_send.dim() == 2 and x_send.shape == (
        chunks * world * bucket, m), f"{what}: x_send {tuple(x_send.shape)} "
        f"is not [chunks*world*bucket, M] = [{chunks * world * bucket}, {m}]")
    _launch.require(wu.shape == wg.shape and wd.shape == (e_local, ffn, m),
                    f"{what}: wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                    f"{tuple(wd.shape)} are not [E, M, F] twice and [E, F, M]")
    _launch.require(len({x_send.dtype, wg.dtype, wu.dtype, wd.dtype}) == 1,
                    f"{what}: x_send and the weights must share a dtype")
    _launch.require(counts.dtype == inv.dtype == torch.int32
                    and counts.shape == (chunks * e_local,)
                    and inv.shape == (chunks * e_local * c_pad,),
                    f"{what}: counts must be int32 [{chunks * e_local}] and "
                    f"inv int32 [{chunks * e_local * c_pad}]")
    _launch.require(c_pad % 64 == 0, f"{what}: c_pad {c_pad} is not a "
                    f"multiple of the kernel's 64-row tile")
    return dev, group, world


def _fused_tma_ok(m: int, ffn: int, *tensors: torch.Tensor) -> bool:
    """Whether a bf16 #17 call of width ``m`` and ffn ``ffn`` over
    ``tensors`` (x_send and the three weights) takes the ``wgmma`` kernels:
    TMA's row strides need M and F multiples of 8 and its bases (and the
    16-byte row gathers) 16-byte alignment; the peers' slots are aligned by
    construction. Otherwise the call takes the CUDA-core kernel, which
    rounds where the ``wgmma`` route rounds."""
    return (m % 8 == 0 and ffn % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _fused_pull(x_send, counts, inv, wg, wu, wd, group, chunks, bucket,
                c_pad, s):
    """Launch ``ptt_fused_a2a_mlp`` once over the peers' slot ``s`` (None: a
    world of one, ``x_send`` itself)."""
    global launches_fused
    dev = x_send.device
    _, me, world = _group_of("fused_a2a_expert_mlp", group)
    e_local, m, ffn = wg.shape
    rows = chunks * e_local * c_pad
    act = torch.empty((rows, ffn), dtype=x_send.dtype, device=dev)
    y = torch.empty((rows, m), dtype=x_send.dtype, device=dev)
    if s is None:
        peers = [x_send.data_ptr()]
    else:
        ring = _rings[group]
        peers = [x_send.data_ptr() if j == me else ring.addr(j, s)
                 for j in range(world)]
    tma = x_send.dtype == torch.bfloat16 and _fused_tma_ok(
        m, ffn, x_send, wg, wu, wd)
    _launch.launch("ptt_fused_a2a_mlp", _pointers(peers), world, me, bucket,
                   inv.data_ptr(), counts.data_ptr(), wg.data_ptr(),
                   wu.data_ptr(), wd.data_ptr(), act.data_ptr(),
                   y.data_ptr(), chunks, e_local, c_pad, m, ffn,
                   _launch.dtype_code(x_send, "fused_a2a_expert_mlp"),
                   int(tma), _launch.stream_of(dev))
    launches_fused += 1
    return y


def release() -> None:
    """Free every group's buffers (collective over each group, in the
    order the groups first exchanged, which is the same on every rank)."""
    for ring in list(_rings.values()):
        ring.release()
    _rings.clear()
