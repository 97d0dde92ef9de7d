"""``paddle.distributed.spawn`` (port of ``paddle_tpu/distributed/spawn.py``):
run ``func(rank, *args)`` in ``nprocs`` local processes under the
``PADDLE_*`` env contract, so that ``init_parallel_env()`` inside
``func`` forms the group."""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from typing import Optional, Sequence

import torch.distributed as dist

from paddle_tpu_torch.distributed.env import _free_port
from paddle_tpu_torch.ops.kernels import async_collectives

__all__ = ["spawn"]


def _worker(func, rank, args, env):
    os.environ.update(env)
    try:
        func(rank, *args)
        # the ring's IPC buffers are freed while their group is still up
        async_collectives.release()
    finally:
        # a rank that exits with its group still up can abort in the
        # backend's teardown; leave the group first
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(func, args: Sequence = (), nprocs: int = 1, join: bool = True,
          master: Optional[str] = None, timeout: Optional[float] = None):
    """Start ``nprocs`` processes (the ``spawn`` start method: CUDA must
    not be forked) running ``func(rank, *args)``; ``func`` and ``args``
    are pickled, so ``func`` is a module-level function. With ``join``,
    wait for all of them: the first rank that fails, or the deadline
    ``timeout`` seconds away, terminates every rank still running and
    raises ``RuntimeError``. Returns the processes."""
    if master is None:
        master = f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_MASTER": master, "PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs)}
        p = ctx.Process(target=_worker, args=(func, rank, tuple(args), env))
        p.start()
        procs.append(p)
    if not join:
        return procs
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = []
    try:
        while any(p.is_alive() for p in procs):
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                break
            if deadline is not None and time.monotonic() > deadline:
                failed = [(r, "timeout") for r, p in enumerate(procs)
                          if p.is_alive()]
                break
            time.sleep(0.05)
        else:
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if p.exitcode != 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError(f"spawn: ranks failed: {failed}")
    return procs
