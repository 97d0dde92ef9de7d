"""Rank body of the KV-page remote copy case of
``tests/test_torch_kv_handoff.py`` (:func:`remote_copy_run`).

Each spawned rank joins a gloo group and a ``["kv"]`` mesh of two, moves
seeded pages from rank 0 to rank 1 through
:func:`~paddle_tpu_torch.ops.kernels.kv_handoff.kv_pages_remote_copy` on
CPU tensors (its twin), checks a group of one is refused, and writes what
it got to ``copy{r}.pt``. Imports torch and the port only.
"""

import os

import torch


def _payload(rank, shape, dtype):
    g = torch.Generator().manual_seed(300 + rank)
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=g, dtype=dtype)
    return torch.randn(shape, generator=g).to(dtype)


def remote_copy_run(rank, work_dir):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    dist.init_parallel_env(backend="gloo")
    mesh = dist.ProcessMesh([0, 1], ["kv"])
    dist.set_mesh(mesh)
    group, peer = mesh.group("kv"), 1 - rank
    out = []
    for shape, dtype, chunks in (((64, 2, 8), torch.bfloat16, 2),
                                 ((64, 2, 8), torch.int8, 1),
                                 ((64, 2), torch.float32, 2),
                                 ((5, 3, 7), torch.bfloat16, 4)):
        x = _payload(rank, shape, dtype)
        n0 = k18.launches
        got = k18.kv_pages_remote_copy(x, 0, 1, chunks=chunks, group=group)
        out.append(dict(equal_source=torch.equal(
            got, _payload(peer, shape, dtype)),
            moved=not torch.equal(got, x), launches=k18.launches - n0))
    # a group of one rank has no peer: refused
    solo = [torch.distributed.new_group([r]) for r in range(2)][rank]
    try:
        k18.kv_pages_remote_copy(torch.zeros(4), 0, 0, group=solo)
        out.append(dict(equal_source=False, moved=False, launches=0))
    except ValueError:
        pass
    torch.save(out, os.path.join(work_dir, f"copy{rank}.pt"))


def remote_copy_cuda_run(rank, work_dir):
    """The same moves on the card: the kernel (a stage into the group's
    IPC slot, a barrier, one pull) against its twin, bit for bit, one
    launch a call, at sizes the 16-byte vectors do and do not divide."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    dist.init_parallel_env(backend="gloo")
    mesh = dist.ProcessMesh([0, 1], ["kv"])
    dist.set_mesh(mesh)
    group, peer = mesh.group("kv"), 1 - rank
    out = []
    for shape, dtype, chunks in (((256, 2, 64), torch.bfloat16, 2),
                                 ((256, 2, 64), torch.int8, 1),
                                 ((256, 2), torch.float32, 2),
                                 ((5, 3, 7), torch.bfloat16, 4),
                                 ((9, 3, 1), torch.int8, 3)):
        x = _payload(rank, shape, dtype).cuda()
        n0 = k18.launches
        got = k18.kv_pages_remote_copy(x, 0, 1, chunks=chunks, group=group)
        launches = k18.launches - n0
        want = k18.kv_pages_remote_copy_plain(x, 0, 1, chunks, group)
        out.append(dict(equal_twin=torch.equal(got, want),
                        equal_source=torch.equal(
                            got.cpu(), _payload(peer, shape, dtype)),
                        moved=not torch.equal(got, x), launches=launches))
    try:
        k18.kv_pages_remote_copy(torch.zeros(4, dtype=torch.float64,
                                             device="cuda"), 0, 1,
                                 group=group)
        out.append(dict(equal_twin=False, equal_source=False, moved=False,
                        launches=0))
    except TypeError:
        pass
    torch.save(out, os.path.join(work_dir, f"copy{rank}.pt"))
