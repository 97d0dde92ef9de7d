"""#18, the KV-page remote copy: the kernel of ``csrc/kv_handoff.cu`` and
its plain twin.

Port of ``kv_pages_remote_copy`` (``paddle_tpu/inference/kv_handoff.py:393``
-> ``pallas_call`` :427), which pushes a packed page tensor ``[rows,
kv_heads, head_dim]`` (K and V stacked along rows; one-byte pages and their
fp32 scales when quantized) from rank ``src`` to rank ``dst`` by remote DMA.
On the card the copy is a pull through CUDA IPC: the source's pages sit in
a buffer it exported, the destination maps it, and :func:`pages_copy`
launches ``ptt_kv_pages_copy`` once, reading the peer's buffer directly.

Two callers share the one kernel:

* :func:`kv_pages_remote_copy`, the reference's SPMD function over a
  process group (a ``ProcessMesh`` axis group, as
  :func:`~paddle_tpu_torch.ops.kernels.async_collectives.ring_kv_rotate`):
  every rank stages its buffer into the group's exported slot (#16's
  ``_Ring``), a stream sync and a gloo barrier follow, then every rank
  pulls from the rank that sends to it, ``offset = dst - src`` back, as the
  TPU kernel's shift-permute does; only ``dst``'s output is meaningful.
  Its twin, :func:`kv_pages_remote_copy_plain`, moves the same bytes
  through the group's backend (gloo: the host).
* the serving fleet's handoff between two host processes
  (``inference/kv_handoff.py``: the prefill host gathers a record's
  segments into an exported buffer, the decode host maps it and pulls each
  segment with :func:`pages_copy`).

CPU tensors take the twin; on CUDA tensors the kernel launches or the call
raises (no group, a group of one, a dtype that is no page or scale type).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from paddle_tpu_torch.ops.kernels import _launch

__all__ = ["kv_pages_remote_copy", "kv_pages_remote_copy_plain",
           "pages_copy", "device_view", "clamp_chunks", "PAGE_DTYPES",
           "launches"]

#: launches of ``ptt_kv_pages_copy`` (one a segment pulled; never by the
#: twin, and not the stage copy of the SPMD call's exchange protocol)
launches = 0

#: what a handoff moves: full-width pages, one-byte pages, their scales
PAGE_DTYPES = tuple(d for d in (
    torch.bfloat16, torch.float16, torch.float32, torch.int8, torch.uint8,
    getattr(torch, "float8_e4m3fn", None), getattr(torch, "float8_e5m2",
                                                   None)) if d is not None)

_MAX_CHUNKS = 65535      # gridDim.y


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CudaArray:
    """``__cuda_array_interface__`` (v3) over raw device bytes, so that
    ``torch.as_tensor`` can view memory the port allocated or mapped
    itself."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (int(nbytes),), "typestr": "|u1",
            "data": (int(ptr), False), "version": 3, "strides": None,
            "stream": None}


def device_view(ptr: int, nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 tensor over ``nbytes`` of device memory at ``ptr`` (an IPC
    buffer of this process, or a peer's mapped into it). No copy."""
    return torch.as_tensor(_CudaArray(ptr, nbytes), device=device)


def clamp_chunks(chunks: int, rows: int) -> int:
    """The reference's clamp: at least 1, at most ``rows``, and a divisor
    of ``rows``."""
    rows = max(int(rows), 1)
    chunks = max(1, min(int(chunks), rows, _MAX_CHUNKS))
    while rows % chunks:
        chunks -= 1
    return chunks


def pages_copy(dst: torch.Tensor, src_ptr: int, chunks: int = 1
               ) -> torch.Tensor:
    """Launch #18 once on the current stream: the ``nbytes(dst)`` bytes at
    device address ``src_ptr`` (a peer's mapped buffer) into ``dst``, as
    ``chunks`` pieces. Asynchronous, like any launch."""
    global launches
    dev = _launch.check_cuda("kv_pages_copy", dst)
    _launch.require(1 <= int(chunks) <= _MAX_CHUNKS,
                    f"kv_pages_copy: {chunks} chunks")
    _launch.launch("ptt_kv_pages_copy", int(src_ptr), dst.data_ptr(),
                   _nbytes(dst), int(chunks), _launch.stream_of(dev))
    launches += 1
    return dst


def _group_of(what: str, group):
    """``(group, rank, world)`` of a real group of two or more ranks."""
    if not dist.is_initialized():
        raise ValueError(f"{what}: no process group (the copy runs over a "
                         f"mesh axis group of two or more ranks)")
    group = dist.group.WORLD if group is None else group
    me, world = dist.get_rank(group), dist.get_world_size(group)
    _launch.require(world > 1, f"{what}: a group of {world} rank has no "
                    f"peer to copy from")
    return group, me, world


def _offset(what, src_rank, dst_rank, world) -> int:
    _launch.require(0 <= src_rank < world and 0 <= dst_rank < world,
                    f"{what}: src {src_rank} and dst {dst_rank} must be "
                    f"ranks of the group of {world}")
    return (int(dst_rank) - int(src_rank)) % world


def kv_pages_remote_copy_plain(pages: torch.Tensor, src_rank: int,
                               dst_rank: int, chunks: int = 2, group=None
                               ) -> torch.Tensor:
    """The twin: every rank sends its ``pages`` to rank ``me + offset`` and
    receives from ``me - offset`` (``offset = dst - src``) through the
    group's backend, as the bytes of one ``ppermute``."""
    from paddle_tpu_torch.distributed import collective
    what = "kv_pages_remote_copy"
    group, me, world = _group_of(what, group)
    off = _offset(what, src_rank, dst_rank, world)
    perm = [(r, (r + off) % world) for r in range(world)]
    flat = pages.contiguous().reshape(-1).view(torch.uint8)
    got = collective.ppermute(flat, perm, group)
    return got.view(pages.dtype).reshape(pages.shape)


def kv_pages_remote_copy(pages: torch.Tensor, src_rank: int, dst_rank: int,
                         chunks: int = 2, group=None) -> torch.Tensor:
    """Ship ``pages [rows, ...]`` from group rank ``src_rank`` to
    ``dst_rank``. SPMD: every rank of ``group`` calls it with a tensor of
    the same shape and dtype and the same pairing; only ``dst_rank``'s
    result is meaningful (the others receive their shifted peer's). CPU
    tensors take :func:`kv_pages_remote_copy_plain`; CUDA tensors stage
    into the group's IPC slot and launch ``ptt_kv_pages_copy`` once, in
    ``chunks`` pieces (clamped to a divisor of the rows)."""
    if pages.device.type == "cpu":
        return kv_pages_remote_copy_plain(pages, src_rank, dst_rank, chunks,
                                          group)
    what = "kv_pages_remote_copy"
    dev = _launch.check_cuda(what, pages)
    if pages.dtype not in PAGE_DTYPES:
        raise TypeError(f"{what}: dtype {pages.dtype} is no page or scale "
                        f"type ({', '.join(map(str, PAGE_DTYPES))})")
    group, me, world = _group_of(what, group)
    off = _offset(what, src_rank, dst_rank, world)
    from paddle_tpu_torch.ops.kernels import async_collectives
    ring = async_collectives._ring(group, dev)
    s, _, _ = ring.stage([pages], _launch.stream_of(dev))
    out = torch.empty_like(pages)
    rows = pages.shape[0] if pages.dim() else 1
    return pages_copy(out, ring.addr((me - off) % world, s),
                      clamp_chunks(chunks, rows))
