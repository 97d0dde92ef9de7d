"""Flag-gated fault injection points of the serving plane (port of the
serving subset of ``paddle_tpu/testing/fault_injection.py:110-346``).

Production code calls the hooks at its failure-prone boundaries; each does
nothing (one flag read) unless the ``fault_injection`` master flag is
armed.

* :func:`on_serve_step` — the serving loop (``inference.server``), once
  per iteration. ``FLAGS_fault_serve_step``: ``delay:SECONDS`` sleeps every
  step; ``crash:N`` raises :class:`SimulatedCrash` on the Nth.
* :func:`client_stalled` — the server's backpressure pass.
  ``FLAGS_fault_serve_client``: ``stall:ID`` wedges request ``ID``'s
  consumer (``stall`` alone wedges every one).
* :func:`deadline_override` — admission. ``FLAGS_fault_serve_deadline``:
  ``storm:SECONDS`` clamps every submitted request's timeout.
* :func:`serve_kill` — each fleet host loop (``inference.router.
  ServingHost``). ``FLAGS_fault_serve_kill``: ``HOST:N`` is True on host
  HOST's Nth iteration (bare ``HOST``: the first), counted per host.
* :func:`router_partitioned` — health posts and router reads.
  ``FLAGS_fault_router_partition``: ``drop:HOST``.
* :func:`trace_drop` — a traced hop to another process.
  ``FLAGS_fault_trace_drop``: ``drop:N`` (or bare ``N``).

:func:`env_snapshot` carries the armed flags into a subprocess host's
environment, which the child's flag registry reads at import. The training
hooks (``on_file_write``, ``on_collective``, ``poison_step``,
``param_flip``) wait for ROADMAP.md A.12.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from paddle_tpu_torch import flags

__all__ = ["SimulatedCrash", "on_serve_step", "client_stalled",
           "deadline_override", "serve_kill", "router_partitioned",
           "trace_drop", "reset", "inject", "env_snapshot", "FAULT_FLAGS"]

# every chaos flag the hooks read; env_snapshot iterates this list
FAULT_FLAGS = ("fault_injection", "fault_serve_step", "fault_serve_client",
               "fault_serve_deadline", "fault_serve_kill",
               "fault_router_partition", "fault_trace_drop")


class SimulatedCrash(BaseException):
    """An injected hard kill: not an ``Exception``, so ``except
    Exception`` cleanup does not swallow it."""


_lock = threading.Lock()
_counters = {"serve_step": 0, "trace_hop": 0}
# per-host serving-loop iterations (fault_serve_kill counts the named
# host's own loop)
_host_steps: dict = {}


def _armed() -> bool:
    return bool(flags.flag("fault_injection"))


def _parse_spec(spec: str):
    """``'mode:arg'`` -> (mode, arg); bare ``'mode'`` -> (mode, '')."""
    spec = (spec or "").strip()
    if not spec:
        return None, ""
    mode, _, arg = spec.partition(":")
    return mode.strip().lower(), arg.strip()


def reset() -> None:
    """Rearm every injection counter."""
    with _lock:
        for k in _counters:
            _counters[k] = 0
        _host_steps.clear()


def _bump(name: str) -> int:
    with _lock:
        _counters[name] += 1
        return _counters[name]


def on_serve_step() -> None:
    """Serving-loop injection point, before the engine step."""
    if not _armed():
        return
    mode, arg = _parse_spec(flags.flag("fault_serve_step"))
    if mode is None:
        return
    n = _bump("serve_step")
    if mode == "delay":
        time.sleep(float(arg or 0.01))
    elif mode == "crash" and n == int(arg or 1):
        raise SimulatedCrash(f"[fault_injection] simulated serving crash "
                             f"at loop step #{n}")


def client_stalled(request_id) -> bool:
    """True when ``request_id``'s stream consumer is wedged."""
    if not _armed():
        return False
    mode, arg = _parse_spec(flags.flag("fault_serve_client"))
    if mode != "stall":
        return False
    return arg == "" or str(request_id) == arg


def deadline_override():
    """The storm timeout every admission clamps to, or None."""
    if not _armed():
        return None
    mode, arg = _parse_spec(flags.flag("fault_serve_deadline"))
    if mode != "storm":
        return None
    return float(arg or 0.0)


def serve_kill(host_name: str) -> bool:
    """True when ``host_name``'s serving loop must die on this
    iteration."""
    if not _armed():
        return False
    mode, arg = _parse_spec(flags.flag("fault_serve_kill"))
    if mode is None or mode != str(host_name):
        return False
    with _lock:
        _host_steps[host_name] = _host_steps.get(host_name, 0) + 1
        n = _host_steps[host_name]
    return n == int(arg or 1)


def router_partitioned(host_name) -> bool:
    """True when messages to or from ``host_name`` are dropped."""
    if not _armed():
        return False
    mode, arg = _parse_spec(flags.flag("fault_router_partition"))
    if mode != "drop":
        return False
    return arg != "" and str(host_name) == arg


def trace_drop() -> bool:
    """True when this traced hop must travel without its context."""
    if not _armed():
        return False
    mode, arg = _parse_spec(flags.flag("fault_trace_drop"))
    if mode is None:
        return False
    if mode == "drop":
        nth = int(arg or 1)
    else:
        try:
            nth = int(mode)
        except ValueError:
            return False
    return _bump("trace_hop") == nth


def env_snapshot() -> dict:
    """The armed chaos flags as ``FLAGS_<name>`` environment variables
    (only values off their defaults), for a subprocess host's env."""
    out = {}
    for name in FAULT_FLAGS:
        value = flags.flag(name)
        if value == flags.flag_default(name):
            continue
        if isinstance(value, bool):
            out[f"FLAGS_{name}"] = "1" if value else "0"
        else:
            out[f"FLAGS_{name}"] = str(value)
    return out


@contextmanager
def inject(**flag_values):
    """Arm fault injection for a ``with`` block: sets
    ``fault_injection=True`` and the given flags, resets the counters, and
    restores both on exit."""
    names = ["fault_injection"] + list(flag_values)
    prev = flags.get_flags(names)
    flags.set_flags({"fault_injection": True, **flag_values})
    reset()
    try:
        yield
    finally:
        flags.set_flags(prev)
        reset()
