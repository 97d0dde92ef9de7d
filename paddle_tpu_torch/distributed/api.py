"""``shard_layer`` (port of the part of ``paddle_tpu/distributed/api.py``
that places a model's parameters over a mesh).

Placements and resharding of activations are ROADMAP.md A.10; here a
``shard_fn`` changes what a sublayer holds (``MoELayer.shard_experts``
keeps this rank's experts), and every parameter it leaves alone stays
replicated: each rank holds all of it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["shard_layer"]


def shard_layer(layer: torch.nn.Module, process_mesh,
                shard_fn: Optional[Callable] = None) -> torch.nn.Module:
    """Call ``shard_fn(sublayer_name, sublayer, process_mesh)`` on every
    sublayer of ``layer`` (itself first, as ``named_modules`` orders them)
    and return ``layer``. Without ``shard_fn`` every parameter stays
    replicated. Build the optimizer after this call."""
    if shard_fn is not None:
        with torch.no_grad():
            for name, sub in list(layer.named_modules()):
                shard_fn(name, sub, process_mesh)
    return layer
