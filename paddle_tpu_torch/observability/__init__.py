"""Observability (port of ``paddle_tpu/observability/``): the surface the
serving plane calls.

The metrics registry, the JSONL sink and the flight recorder are not
ported yet (ROADMAP.md A.12): :func:`enabled` is False, and :func:`inc`,
:func:`set_gauge`, :func:`event` and :func:`flush` do nothing, which is
what the reference's calls do with ``FLAGS_obs_metrics`` off.
:mod:`~paddle_tpu_torch.observability.tracing` holds the trace-context
API; :mod:`~paddle_tpu_torch.observability.ops` the fleet's health post.
"""

from __future__ import annotations

__all__ = ["enabled", "inc", "set_gauge", "event", "flush"]

# the reference's JSONL sink; none until A.12
_sink = None


def enabled() -> bool:
    return False


def inc(name: str, value: float = 1, **labels) -> None:
    pass


def set_gauge(name: str, value: float, **labels) -> None:
    pass


def event(name: str, **fields) -> None:
    pass


def flush() -> None:
    pass
