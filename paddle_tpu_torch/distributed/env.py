"""Distributed bootstrap (port of ``paddle_tpu/distributed/env.py``).

``init_parallel_env`` forms the process group over
``torch.distributed.init_process_group`` from the reference's env
contract: ``PADDLE_MASTER`` (``host:port`` of the rendezvous),
``PADDLE_TRAINER_ID`` (this process's rank) and ``PADDLE_TRAINERS_NUM``
(the world size), as :func:`paddle_tpu_torch.distributed.spawn` sets
them. The backend is ``"nccl"`` when CUDA is available and ``"gloo"``
otherwise; ranks that share one card pass ``backend="gloo"`` themselves
(NCCL refuses two ranks on one GPU). Each rank's device is
``cuda:{local_rank % device_count}``.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from paddle_tpu_torch.framework.place import resolve_device

__all__ = ["init_parallel_env", "is_initialized", "get_rank",
           "get_world_size", "ParallelEnv"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_parallel_env(backend: Optional[str] = None) -> "ParallelEnv":
    """Join the process group named by the env contract (a world of one
    rank without it) and bind this rank's CUDA device. Idempotent."""
    if dist.is_initialized():
        return ParallelEnv()
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master = os.environ.get("PADDLE_MASTER")
    if master is None:
        if world != 1:
            raise RuntimeError(
                f"init_parallel_env: PADDLE_TRAINERS_NUM={world} needs "
                f"PADDLE_MASTER (host:port of the rendezvous)")
        master = f"127.0.0.1:{_free_port()}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif backend == "nccl":
        raise RuntimeError("init_parallel_env: the nccl backend needs a "
                           "CUDA device; pass backend='gloo' on the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{master}",
                            world_size=world, rank=rank)
    return ParallelEnv()


def is_initialized() -> bool:
    return dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (the default group: the world);
    0 before :func:`init_parallel_env`."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


class ParallelEnv:
    """Reference ``paddle.distributed.ParallelEnv`` surface."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def nranks(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        # one host: the rank is the local rank, as in the reference
        return get_rank()

    @property
    def device_count(self) -> int:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    @property
    def device_id(self) -> int:
        n = self.device_count
        return self.local_rank % n if n else 0

    @property
    def device(self) -> torch.device:
        """``cuda:{device_id}``; raises, as :func:`resolve_device` does,
        where no CUDA device exists (a CPU run names its device itself)."""
        return resolve_device(f"cuda:{self.device_id}")
