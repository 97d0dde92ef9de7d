"""Random generators (port of ``paddle_tpu/framework/random.py``).

The JAX package threads a global PRNG key; the port hands explicit
``torch.Generator`` objects to whatever draws random numbers. The two
give different numbers from the same seed, so tests that compare the
port with JAX make their inputs with numpy and carry weights across with
:func:`paddle_tpu_torch.weights.load_jax_state`.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.framework.place import resolve_device

__all__ = ["seed"]


def seed(seed_: int, device=None) -> torch.Generator:
    """A generator on the target device (``cuda`` by default), seeded."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed_))
    return g
