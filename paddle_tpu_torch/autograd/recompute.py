"""Activation recomputation (port of ``paddle_tpu/autograd/recompute.py``).

``recompute(function, *args)`` runs ``function`` without keeping its
internal activations; the backward replays it to rebuild them
(``torch.utils.checkpoint`` without reentrancy, which also restores the
random state for the replay, as the reference's ``jax.checkpoint`` replays
its threaded key). On the card the replay launches the same kernels on the
same stream, so it rebuilds the same bits.

The aux-stash protocol is the reference's (``recompute.py:23-47``): a
sublayer that computes a scalar side output in its forward (the MoE gates'
load-balance loss) leaves it on ``<obj>._loss``, where ``<obj>`` is the
sublayer or one of its ``AUX_STASH_ATTRS``. The forward's value stays
there for the loss to read (``gate.get_loss()``); the backward's replay
sets it again, so the replay's value is dropped and the forward's put back
(``recompute.py:96-113``), and ``get_loss()`` stays readable after the
step.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "AUX_STASH_ATTRS"]

AUX_STASH_ATTRS = ("gate", "router")


def _aux_holders(function):
    """Objects whose ``_loss`` takes part in the aux-stash protocol."""
    if not isinstance(function, torch.nn.Module):
        return []
    holders = []
    for sub in function.modules():
        for obj in [sub] + [getattr(sub, a, None) for a in AUX_STASH_ATTRS]:
            if obj is not None and hasattr(obj, "_loss") \
                    and all(obj is not h for h in holders):
                holders.append(obj)
    return holders


def recompute(function, *args, use_reentrant: bool = True, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward. ``function`` is a module or any callable over tensors.
    ``use_reentrant`` is accepted for the reference's signature; both values
    take the same route, as both do in the reference."""
    del use_reentrant
    holders = _aux_holders(function)
    replaying = False

    def run(*a):
        kept = [(h, h._loss) for h in holders]
        try:
            return function(*a, **kwargs)
        finally:
            if replaying:
                for h, loss in kept:
                    h._loss = loss

    out = checkpoint(run, *args, use_reentrant=False)
    replaying = True
    return out
