"""Launch-side services of the serving fleet (port of
``paddle_tpu/distributed/launch/``): the cluster master
(:mod:`~paddle_tpu_torch.distributed.launch.master`) and the fleet's host
process (``python -m paddle_tpu_torch.distributed.launch.serve_host``).
The multi-process training launcher (``launch``, ``main.py``) is not ported
yet (ROADMAP.md A.10)."""

from paddle_tpu_torch.distributed.launch.master import (  # noqa: F401
    HTTPMaster, MasterClient)

__all__ = ["HTTPMaster", "MasterClient", "launch"]


def launch(*args, **kwargs):
    raise NotImplementedError(
        "paddle_tpu_torch.distributed.launch.launch (the multi-process "
        "training launcher) is not ported yet (ROADMAP.md A.10)")
