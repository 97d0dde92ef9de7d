"""``to_static`` (port of ``paddle_tpu/jit/api.py``, the decorator form).

The reference traces the decorated train step into one XLA program. The
port runs the step as written, eagerly: every kernel and every PyTorch
op is its own launch, and nothing is captured. CUDA-graph capture of the
step is queued in ROADMAP.md (A.3). The decorator exists so that a train
loop reads as it does against the reference.
"""

from __future__ import annotations

__all__ = ["to_static"]


def to_static(function):
    """Return ``function`` unchanged: the step runs eagerly."""
    return function
