"""Request-scoped distributed tracing across the serving fleet (port of
``paddle_tpu/observability/tracing.py``).

The context API is pure Python and ported whole: a W3C-traceparent-style
context (:class:`TraceContext`) is minted at router admission
(:func:`mint`), serialized for each process hop (:func:`header` /
:func:`from_header`, the ``X-Paddle-Trace`` HTTP header and the handoff
record's ``trace`` field), and derived per leg (:func:`child`). Sampling
(:func:`sampled`) is a deterministic hash of the request id.

Header format: ``00-<32 hex trace_id>-<16 hex span_id>-<01|00>``.

Span recording needs the span sink, the flight recorder ring and the JSONL
stream, which are not ported (ROADMAP.md A.12): :func:`configure` with
``enabled=True`` raises, so tracing is always off and :func:`mint`,
:func:`begin`, :func:`finish`, :func:`record` and :func:`ctx_of` are the
reference's disabled fast path, one bool read each.
"""

from __future__ import annotations

import hashlib
import itertools
import os
from typing import Any, Optional

__all__ = ["TraceContext", "TRACE_HEADER", "enabled", "configure", "mint",
           "sampled", "from_header", "header", "child", "begin", "finish",
           "ctx_of", "record", "sample_rate"]

TRACE_HEADER = "X-Paddle-Trace"

_enabled: bool = False
_sample: float = 1.0
_span_seq = itertools.count(1)


def enabled() -> bool:
    return _enabled


def sample_rate() -> float:
    return _sample


def configure(enabled: bool = False, sample: float = 1.0) -> None:
    """Set the sampling rate; arming tracing raises until its span sink is
    ported."""
    global _sample
    if enabled:
        raise NotImplementedError(
            "observability.tracing: span recording (the flight recorder "
            "ring and the JSONL sink) is not ported to paddle_tpu_torch "
            "yet (ROADMAP.md A.12)")
    _sample = min(1.0, max(0.0, float(sample)))


class TraceContext:
    """One hop's view of a trace: the trace id, the span id local spans
    parent under, and the sampling verdict."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id[:8]}…, {self.span_id}, "
                f"sampled={self.sampled})")


def _new_span_id() -> str:
    """Process-unique 16-hex span id: pid and a per-process counter."""
    return (f"{os.getpid() & 0xFFFFFFFF:08x}"
            f"{next(_span_seq) & 0xFFFFFFFF:08x}")


def sampled(key: Any) -> bool:
    """Deterministic per-request sampling verdict: a hash of the request
    id in [0, 1) against the sampling rate."""
    if _sample >= 1.0:
        return True
    if _sample <= 0.0:
        return False
    h = hashlib.sha1(repr(key).encode()).digest()
    return int.from_bytes(h[:4], "big") / 2.0 ** 32 < _sample


def mint(key: Any) -> Optional[TraceContext]:
    """A root context for a request; None while tracing is off."""
    if not _enabled:
        return None
    tid = hashlib.sha1(repr(key).encode()).hexdigest()[:32]
    return TraceContext(tid, _new_span_id(), sampled(key))


def from_header(value: Optional[str]) -> Optional[TraceContext]:
    """Parse a propagated header; None when off, missing or malformed."""
    if not _enabled or not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    tid, sid, flg = parts[1], parts[2], parts[3]
    if len(tid) != 32 or len(sid) != 16:
        return None
    return TraceContext(tid, sid, flg == "01")


def header(ctx: Optional[TraceContext]) -> Optional[str]:
    """Serialize a context for the wire; None passes through."""
    if ctx is None:
        return None
    return (f"00-{ctx.trace_id}-{ctx.span_id}-"
            f"{'01' if ctx.sampled else '00'}")


def child(ctx: TraceContext) -> TraceContext:
    """A derived context with a fresh span id."""
    return TraceContext(ctx.trace_id, _new_span_id(), ctx.sampled)


def begin(ctx: Optional[TraceContext], name: str, **fields):
    """Open a live span: None while tracing is off."""
    return None


def finish(tok, **extra) -> None:
    """Close a live span; a None token is the off path."""


def ctx_of(tok) -> Optional[TraceContext]:
    """The context downstream hops carry under span ``tok``."""
    if tok is None:
        return None
    return TraceContext(tok[0], tok[1], True)


def record(ctx: Optional[TraceContext], name: str, start_ts: float,
           dur_ms: float, root: bool = False, **fields) -> None:
    """A retroactive span: nothing while tracing is off."""
