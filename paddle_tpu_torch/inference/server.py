"""Request-level serving loop over the continuous-batching engine (port
of ``paddle_tpu/inference/server.py``).

:class:`GenerationEngine` owns the *batch*: slots, KV pages, chunked
prefill, the compiled decode step. This module owns the *request
lifecycle* around it:

* **deadlines** — every request may carry a wall-clock timeout
  (relative, ``timeout_s``) or an absolute client deadline
  (``deadline_s``); an expired request is evicted mid-decode and its KV
  pages are back on the free-list in the same loop iteration
  (``finish_reason="timeout"`` / ``"deadline"``);
* **admission control** — a bounded FIFO wait queue plus a token-budget
  gate: a request is only admitted when the engine has a free slot AND
  enough free KV blocks for its estimated prompt+output footprint, so a
  burst of long requests queues instead of thrashing the cache;
* **load shedding** — when the wait queue is full, or the oldest queued
  request has waited longer than ``queue_wait_budget_s``, NEW
  submissions finish immediately with ``finish_reason="shed"`` —
  reject-newest keeps goodput flat under overload instead of letting
  every request time out;
* **client-stream backpressure** — each request streams tokens through
  a bounded buffer on its :class:`RequestHandle`; a consumer that stops
  reading fills the buffer and the server *pauses that request only*
  (it keeps slot + pages, contributes no step tokens) — the batch never
  stalls for one slow client;
* **graceful drain** — :meth:`GenerationServer.drain` (or SIGTERM via
  :meth:`install_sigterm` + :meth:`serve_forever`) stops admission and
  requeue-serializes every admitted-and-unfinished request to a JSON
  file; :meth:`resubmit_drained` on a fresh server re-admits them with
  their remaining token and time budgets, so a preemption loses zero
  admitted-and-unexpired requests.

The loop is single-threaded (one engine, one device stream);
``submit`` and the handle-consuming side are thread-safe, so clients
may live on other threads while :meth:`serve_forever` drives the
engine. Chaos hooks (`fault_serve_*` flags) ride
:mod:`paddle_tpu_torch.testing.fault_injection`.

A prefilled request (:meth:`GenerationServer.submit_prefilled`) installs
its handoff record at admission. One departure from the reference: a
device-to-device record whose source does not confirm its buffer across
the pull (:class:`~paddle_tpu_torch.inference.kv_handoff.HandoffRefused`)
finishes ``"shed"`` with an error naming the refusal, so the router
replays the request from its journal; the host tier's spill pass, the
metrics stream and the per-process health reporter that reads the
serving snapshot are not ported (ROADMAP.md A.7, A.12).
"""

from __future__ import annotations

import collections
import glob as _glob
import itertools
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference.engine import (GenerationEngine,
                                               GenerationRequest)
from paddle_tpu_torch.inference.kv_handoff import HandoffRefused
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.testing import fault_injection

__all__ = ["GenerationServer", "RequestHandle", "HANDOFF_REFUSED"]

_log = logging.getLogger("paddle_tpu_torch.inference.server")

#: the error prefix of a decode leg whose handoff pull was refused (the
#: router drops that record and replays from the journal)
HANDOFF_REFUSED = "handoff refused"

_OK_REASONS = ("eos", "length", "cache_exhausted")


class RequestHandle:
    """The client's view of one submitted request: a token stream with
    a bounded buffer (the backpressure signal) plus lifecycle
    timestamps. Consumers may live on any thread."""

    def __init__(self, server: "GenerationServer",
                 request: GenerationRequest, stream_buffer: int):
        self.request = request
        self.request_id = request.request_id
        self._server = server
        self._buffer: collections.deque = collections.deque()
        self._stream_buffer = int(stream_buffer)   # 0 = unbounded
        self._cond = threading.Condition()
        self._cursor = 0          # engine output tokens already streamed
        self._prior: List[int] = []   # tokens from before a drain/restart
        self._handoff = None      # prefilled KV record awaiting install
        self.submit_ts = time.monotonic()
        self.admit_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.deadline: Optional[float] = None      # monotonic
        self.deadline_kind: Optional[str] = None   # "timeout" | "deadline"
        self._done = False

    # -- consumer side --------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done

    @property
    def finish_reason(self) -> Optional[str]:
        return self.request.finish_reason

    @property
    def output_ids(self) -> List[int]:
        return self._prior + self.request.output_ids

    def next_token(self, timeout: Optional[float] = None) -> Optional[int]:
        """Pop the next streamed token; None once the request is done
        and the buffer is drained (or after ``timeout`` seconds)."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._buffer or self._done, timeout=timeout)
            if self._buffer:
                return self._buffer.popleft()
            return None

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until the request finishes; returns output + reason."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done,
                                       timeout=timeout):
                raise TimeoutError(
                    f"request {self.request_id} still running")
        return {"output_ids": self.output_ids,
                "finish_reason": self.request.finish_reason,
                "error": self.request.error}

    # -- server side ----------------------------------------------------
    def _stalled(self) -> bool:
        """Backpressure verdict: the consumer stopped draining (buffer
        at capacity), or a client-stall fault wedges it."""
        if fault_injection.client_stalled(self.request_id):
            return True
        return (self._stream_buffer > 0
                and len(self._buffer) >= self._stream_buffer)

    def _deliver(self) -> None:
        """Push newly generated tokens into the stream buffer."""
        out = self.request.output_ids
        if self._cursor >= len(out):
            return
        with self._cond:
            while self._cursor < len(out):
                self._buffer.append(out[self._cursor])
                self._cursor += 1
            if self.first_token_ts is None:
                self.first_token_ts = time.monotonic()
            self._cond.notify_all()

    def _finalize(self) -> None:
        with self._cond:
            self._done = True
            self.finish_ts = time.monotonic()
            self._cond.notify_all()


class GenerationServer:
    """Deadline-aware, load-shedding, drainable serving loop around one
    :class:`GenerationEngine`. See the module docstring for semantics.

    Parameters
    ----------
    max_queue: bound of the wait queue; a submission that finds it full
        is shed immediately.
    queue_wait_budget_s: once the OLDEST queued request has waited this
        long, new submissions are shed (reject-newest). None: only the
        queue bound sheds.
    default_timeout_s: timeout applied to requests submitted without
        one. None: no implicit deadline.
    stream_buffer: per-request token-stream buffer bound driving
        backpressure; 0 streams unbounded (no pause possible).
    drain_path: default target for :meth:`drain`'s requeue
        serialization — a file path or a directory. The written file is
        always nonced (``<stem>.<pid>-<seq><ext>``) so two servers on
        one host sharing a default path can never clobber each other's
        requeue records; the actual file lands in
        :attr:`last_drain_path`, and :meth:`resubmit_drained` accepts
        the directory or a glob to pick every server's records up.
    """

    _drain_seq = itertools.count()   # process-wide drain-file nonce

    def __init__(self, engine: GenerationEngine, max_queue: int = 64,
                 queue_wait_budget_s: Optional[float] = None,
                 default_timeout_s: Optional[float] = None,
                 stream_buffer: int = 0,
                 drain_path: Optional[str] = None):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.queue_wait_budget_s = queue_wait_budget_s
        self.default_timeout_s = default_timeout_s
        self.stream_buffer = int(stream_buffer)
        self.drain_path = drain_path
        self._lock = threading.RLock()
        self._queue: collections.deque = collections.deque()  # handles
        self._active: Dict[Any, RequestHandle] = {}
        self.handles: Dict[Any, RequestHandle] = {}
        self.counters = {"submitted": 0, "completed": 0, "shed": 0,
                         "timeout": 0, "deadline_miss": 0, "drained": 0,
                         "rejected": 0, "cache_exhausted": 0}
        self.loop_steps = 0
        self._last_step_ts = time.monotonic()
        self._draining = False
        self._drain_requested = threading.Event()
        self._stopped = threading.Event()
        self.last_drain_path: Optional[str] = None
        self._prev_sigterm = None
        self._closed = False

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, request: GenerationRequest,
               timeout_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               handoff: Optional[Dict[str, Any]] = None) -> RequestHandle:
        """Accept a request into the serving lifecycle. Never raises on
        overload — the returned handle finishes with
        ``finish_reason="shed"`` (queue full / wait budget blown /
        draining) or ``"rejected"`` (never admittable) instead.
        ``handoff``: a prefill→decode KV record for this request; its
        admission installs the pages (:meth:`submit_prefilled` builds
        the request from the record for you)."""
        handle = RequestHandle(self, request, self.stream_buffer)
        handle._handoff = handoff
        now = handle.submit_ts
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        storm = fault_injection.deadline_override()
        if storm is not None:
            timeout_s = storm if timeout_s is None \
                else min(timeout_s, storm)
        if timeout_s is not None:
            handle.deadline = now + max(0.0, float(timeout_s))
            handle.deadline_kind = "timeout"
        if deadline_s is not None:
            # absolute wall-clock deadline; the tighter bound wins
            rel = float(deadline_s) - time.time()
            dl = now + max(0.0, rel)
            if handle.deadline is None or dl < handle.deadline:
                handle.deadline = dl
                handle.deadline_kind = "deadline"
        with self._lock:
            self.counters["submitted"] += 1
            self.handles[request.request_id] = handle
            if not self.engine._admissible(request):
                self.engine._reject(
                    request,
                    f"prompt of {len(request.input_ids)} tokens can "
                    f"never be admitted (max_seq_len="
                    f"{self.engine.max_seq_len}, pool="
                    f"{self.engine.cache.num_blocks} blocks)")
                self._finalize(handle)
                return handle
            if self._draining:
                self._shed(handle, "server draining")
                return handle
            if len(self._queue) >= self.max_queue:
                self._shed(handle, f"wait queue full "
                                   f"({self.max_queue} requests)")
                return handle
            if (self.queue_wait_budget_s is not None and self._queue
                    and now - self._queue[0].submit_ts
                    > self.queue_wait_budget_s):
                self._shed(handle, f"queue delay exceeded "
                                   f"{self.queue_wait_budget_s}s budget")
                return handle
            self._queue.append(handle)
        return handle

    def submit_prefilled(self, record: Dict[str, Any],
                         timeout_s: Optional[float] = None,
                         deadline_s: Optional[float] = None
                         ) -> RequestHandle:
        """Accept a prefill host's KV handoff record: the request joins
        the queue with its pages attached, and admission installs them
        (:meth:`GenerationEngine.import_request`) instead of paying
        prefill again — the next engine step decodes. The prefill-side
        tokens in ``record["generated"]`` stream to this host's client
        first, so the consumer sees one uninterrupted stream."""
        req = GenerationRequest(
            record["request_id"], list(record["prompt"]),
            max_new_tokens=int(record["max_new_tokens"]),
            temperature=record.get("temperature", 0.0),
            top_k=record.get("top_k", 0),
            top_p=record.get("top_p", 1.0),
            eos_token_id=record.get("eos_token_id"),
            seed=record.get("seed"))
        req.output_ids = list(record.get("generated") or [])
        req._prompt_pos = len(req.input_ids)
        # the v3 handoff record carries the serialized trace context;
        # installing it here stitches the decode host's spans into the
        # request's cross-process tree
        ctx = tracing.from_header(record.get("trace"))
        if ctx is not None:
            req.trace = ctx
        return self.submit(req, timeout_s=timeout_s,
                           deadline_s=deadline_s, handoff=record)

    def _shed(self, handle: RequestHandle, msg: str) -> None:
        handle.request.finished = True
        handle.request.finish_reason = "shed"
        handle.request.error = msg
        self._finalize(handle)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def step(self) -> None:
        """One serving-loop iteration: expire → admit → backpressure →
        engine step → reap/stream → admit again. Expiry and reaping
        free KV pages BEFORE the admission passes of the same
        iteration, so a full cache plus a finished request turns a slot
        around in one step."""
        fault_injection.on_serve_step()
        now = time.monotonic()
        with self._lock:
            self._expire_pass(now)
            self._admit_pass()
            for h in self._active.values():
                h.request.paused = h._stalled()
        self.engine.step()
        with self._lock:
            for h in list(self._active.values()):
                h._deliver()
            self._reap()
            self._admit_pass()
            self.loop_steps += 1
            self._last_step_ts = time.monotonic()
        self._publish_gauges()

    def _expire_pass(self, now: float) -> None:
        for h in list(self._active.values()):
            if h.deadline is not None and now > h.deadline:
                self.engine.evict(h.request_id,
                                  h.deadline_kind or "timeout")
        expired = [h for h in self._queue
                   if h.deadline is not None and now > h.deadline]
        for h in expired:
            self._queue.remove(h)
            h.request.finished = True
            h.request.finish_reason = h.deadline_kind or "timeout"
            h.request.error = "expired while queued"
            self._finalize(h)

    def _admit_pass(self) -> None:
        """FIFO admission under the token-budget gate: the engine must
        have a free slot and enough OBTAINABLE blocks for the head
        request's estimated prompt+output footprint (capped at the
        whole pool so an over-long estimate can still run alone and
        finish ``cache_exhausted`` rather than wedge the queue).
        Obtainable = free list + evictable/spillable prefix-index
        entries (``available_blocks`` — allocation takes those under
        pressure), plus, on a tiered cache, paused requests' parkable
        page runs, which a spill pass frees on the spot. Gating on
        ``free_blocks`` alone would wedge a warm index: a pool fully
        pinned by cold refs==1 prefix entries admits nothing even
        though every one of those blocks is one eviction away."""
        if self._draining:
            return
        cache = self.engine.cache
        while self._queue:
            head = self._queue[0]
            est = min(self.engine.estimated_blocks(head.request),
                      cache.num_blocks)
            if cache.available_blocks < est:
                if cache.host_tier is not None:
                    # two-tier pressure relief: park paused requests'
                    # page runs in the host tier — the freed device
                    # blocks admit the head NOW, and the parked run
                    # restores (pre-issued) when its consumer resumes.
                    # The queue waits instead of shedding whenever the
                    # spillable+available total covers the estimate.
                    self.engine.spill_paused(
                        est - cache.available_blocks)
                if cache.available_blocks < est:
                    return
            ctx = getattr(head.request, "trace", None)
            if head._handoff is not None:
                # prefilled elsewhere: install pages instead of re-
                # paying prefill; the record's refcounts ride along
                tok = tracing.begin(ctx, "handoff.install",
                                    request_id=head.request_id)
                try:
                    got = self.engine.import_request(head._handoff,
                                                     request=head.request)
                except HandoffRefused as e:
                    # the source no longer holds the pages: this leg
                    # cannot run; the router replays from its journal
                    tracing.finish(tok, installed=False)
                    self._queue.popleft()
                    head._handoff = None
                    self._shed(head, f"{HANDOFF_REFUSED}: {e}")
                    continue
                if got is None:
                    tracing.finish(tok, installed=False)
                    return                  # no free slot/blocks yet
                tracing.finish(tok)
                head._handoff = None        # pages landed; drop the copy
            elif not self.engine.add_request(head.request):
                return                      # no free slot
            self._queue.popleft()
            head.admit_ts = time.monotonic()
            if ctx is not None:
                # admission-queue wait, backdated from the monotonic
                # submit stamp (spans carry wall-clock timestamps)
                wait = head.admit_ts - head.submit_ts
                tracing.record(ctx, "server.queue",
                               time.time() - wait, wait * 1e3,
                               request_id=head.request_id)
            self._active[head.request_id] = head

    def _reap(self) -> None:
        for req in self.engine.reap_finished():
            h = self._active.pop(req.request_id, None)
            if h is None:
                continue
            h._deliver()
            self._finalize(h)

    def _finalize(self, handle: RequestHandle) -> None:
        reason = handle.request.finish_reason
        key = {"eos": "completed", "length": "completed",
               "timeout": "timeout", "deadline": "deadline_miss",
               "shed": "shed", "drained": "drained",
               "rejected": "rejected",
               "cache_exhausted": "cache_exhausted"}.get(reason)
        if key:
            self.counters[key] += 1
        handle._finalize()
        if obs.enabled():
            now = handle.finish_ts
            obs.inc("serve_requests", reason=reason or "unknown")
            if reason == "shed":
                obs.inc("serve_shed")
            elif reason == "timeout":
                obs.inc("serve_timeouts")
            elif reason == "deadline":
                obs.inc("serve_deadline_miss")
            obs.event(
                "serve_request", request_id=handle.request_id,
                finish_reason=reason,
                prompt_tokens=len(handle.request.input_ids),
                new_tokens=len(handle.request.output_ids),
                queue_ms=None if handle.admit_ts is None else
                (handle.admit_ts - handle.submit_ts) * 1e3,
                ttft_ms=None if handle.first_token_ts is None else
                (handle.first_token_ts - handle.submit_ts) * 1e3,
                e2e_ms=(now - handle.submit_ts) * 1e3,
                submit_ts=handle.submit_ts)

    def _publish_gauges(self) -> None:
        if not obs.enabled():
            return
        obs.set_gauge("serve_queue_depth", len(self._queue))
        obs.set_gauge("serve_active_requests", len(self._active))
        tier = self.engine.cache.host_tier
        if tier is not None:
            obs.set_gauge("serve_parked_slots",
                          len(self.engine.cache._slot_spill))
            obs.set_gauge("kv_tier_host_free_blocks", tier.free_blocks)

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def _pending(self) -> bool:
        with self._lock:
            return bool(self._queue or self._active
                        or self.engine.num_active)

    def run_until_idle(self, max_steps: int = 10_000) -> bool:
        """Drive the loop until every submitted request has finished
        (synchronous callers / tests). Paused requests park the loop
        only if nothing else can make progress.

        Returns True once idle. Exhausting ``max_steps`` with work
        still pending is NOT silent: it logs a structured warning,
        bumps the ``serve_idle_exhausted`` obs counter, emits a
        ``serve_idle_exhausted`` event, and returns False — the
        pending requests stay queued/active for further steps."""
        idle_spins = 0
        for _ in range(max_steps):
            if not self._pending():
                return True
            self.step()
            # all-paused batches make no engine progress; expiry can
            # still unstick them, so spin a few times, then yield
            with self._lock:
                moving = any(not h.request.paused
                             for h in self._active.values()) \
                    or self._queue
            if not moving:
                idle_spins += 1
                if idle_spins > 2:
                    time.sleep(0.001)
            else:
                idle_spins = 0
        if not self._pending():
            return True
        with self._lock:
            queued, active = len(self._queue), len(self._active)
        _log.warning(
            "run_until_idle exhausted max_steps=%d with work pending "
            "(queue=%d, active=%d) — requests remain queued/active",
            max_steps, queued, active)
        if obs.enabled():
            obs.inc("serve_idle_exhausted")
            obs.event("serve_idle_exhausted", max_steps=max_steps,
                      queue_depth=queued, active=active)
        return False

    def serve_forever(self, poll_s: float = 0.002) -> None:
        """Drive the loop until :meth:`stop` — or a drain request
        (SIGTERM via :meth:`install_sigterm`, or :meth:`request_drain`)
        — arrives; a drain serializes survivors to ``drain_path`` and
        returns after the loop exits clean."""
        while not self._stopped.is_set():
            if self._drain_requested.is_set():
                self.drain(path=self.drain_path)
                return
            if self._pending():
                self.step()
            else:
                time.sleep(poll_s)

    def stop(self) -> None:
        self._stopped.set()

    def request_drain(self) -> None:
        """Signal-safe drain trigger (the SIGTERM handler body)."""
        self._drain_requested.set()

    def install_sigterm(self) -> None:
        """Route SIGTERM to a graceful drain (call from the main
        thread; the loop may run anywhere)."""
        self._prev_sigterm = signal.signal(
            signal.SIGTERM, lambda _sig, _frm: self.request_drain())

    # ------------------------------------------------------------------
    # drain / restore
    # ------------------------------------------------------------------
    def drain(self, path: Optional[str] = None,
              finish_active: bool = False,
              max_steps: int = 10_000) -> List[Dict[str, Any]]:
        """Graceful shutdown: stop admitting, then requeue-serialize
        every admitted-and-unfinished request (prompt + generated
        prefix + remaining token/time budget) so a restarted server
        can finish it. With ``finish_active=True`` in-flight requests
        run to completion first and only the wait queue serializes.
        Every KV page is back on the free-list when this returns."""
        with self._lock:
            self._draining = True
        if finish_active:
            for _ in range(max_steps):
                with self._lock:
                    if not (self._active or self.engine.num_active):
                        break
                    for h in self._active.values():
                        h.request.paused = False   # finish beats pause
                self.engine.step()
                with self._lock:
                    for h in list(self._active.values()):
                        h._deliver()
                    self._reap()
        records: List[Dict[str, Any]] = []
        now = time.monotonic()
        with self._lock:
            for h in list(self._active.values()) + list(self._queue):
                records.append(self._serialize(h, now))
            for h in list(self._active.values()):
                self.engine.evict(h.request_id, "drained")
            self._reap()
            for h in list(self._queue):
                h.request.finished = True
                h.request.finish_reason = "drained"
                self._finalize(h)
            self._queue.clear()
        if path:
            target = self._drain_target(path)
            with open(target, "w", encoding="utf-8") as f:
                json.dump({"version": 1, "ts": time.time(),
                           "requests": records}, f)
            self.last_drain_path = target
        return records

    @classmethod
    def _drain_target(cls, path: str) -> str:
        """Collision-proof requeue filename: the written file is
        ``<stem>.<pid>-<seq><ext>`` (or ``drain.<pid>-<seq>.json``
        inside a directory target), so two servers sharing one
        ``drain_path`` serialize to distinct files instead of the
        second overwriting the first's records."""
        nonce = f"{os.getpid()}-{next(cls._drain_seq)}"
        if path.endswith(os.sep) or os.path.isdir(path):
            return os.path.join(path, f"drain.{nonce}.json")
        stem, ext = os.path.splitext(path)
        return f"{stem}.{nonce}{ext or '.json'}"

    @staticmethod
    def _serialize(handle: RequestHandle, now: float) -> Dict[str, Any]:
        req = handle.request
        return {
            "request_id": req.request_id,
            "prompt": list(req.input_ids),
            "generated": handle._prior + list(req.output_ids),
            "max_new_tokens": len(handle._prior) + req.max_new_tokens,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "top_p": req.top_p,
            "eos_token_id": req.eos_token_id,
            "seed": req.seed,
            "remaining_s": None if handle.deadline is None
            else handle.deadline - now,
            "deadline_kind": handle.deadline_kind,
        }

    def resubmit_drained(self, source) -> Dict[Any, RequestHandle]:
        """Re-admit requests a previous server serialized — ``source``
        is a drain file path, a DIRECTORY or GLOB covering several
        servers' nonced drain files, or the record list :meth:`drain`
        returned. The generated prefix rides into the new prompt (KV
        is rebuilt by prefill) and shows up in ``handle.output_ids``,
        so the client sees one uninterrupted stream; remaining time
        budgets carry over. Records already expired are dropped (they
        are no longer *unexpired* — nothing owed), and a request id
        appearing in several files keeps only its newest record (a
        request is never resubmitted twice). Returns
        ``{request_id: handle}``."""
        if isinstance(source, str):
            if os.path.isdir(source):
                paths = _glob.glob(os.path.join(source, "*.json"))
            elif os.path.isfile(source):
                paths = [source]
            else:
                paths = _glob.glob(source)
            files = []
            for p in paths:
                with open(p, encoding="utf-8") as f:
                    files.append(json.load(f))
            files.sort(key=lambda d: d.get("ts", 0.0))
            merged: Dict[Any, Dict[str, Any]] = {}
            for payload in files:       # newest file wins per request
                for rec in payload.get("requests", []):
                    merged[rec["request_id"]] = rec
            source = list(merged.values())
        out: Dict[Any, RequestHandle] = {}
        for rec in source:
            remaining = rec.get("remaining_s")
            if remaining is not None and remaining <= 0:
                continue
            prior = list(rec.get("generated") or [])
            req = GenerationRequest(
                rec["request_id"],
                list(rec["prompt"]) + prior,
                max_new_tokens=max(1, int(rec["max_new_tokens"])
                                   - len(prior)),
                temperature=rec.get("temperature", 0.0),
                top_k=rec.get("top_k", 0),
                top_p=rec.get("top_p", 1.0),
                eos_token_id=rec.get("eos_token_id"),
                seed=rec.get("seed"))
            kind = rec.get("deadline_kind")
            handle = self.submit(
                req, timeout_s=remaining if kind != "deadline" else None,
                deadline_s=None if kind != "deadline"
                else time.time() + remaining)
            handle._prior = prior
            out[rec["request_id"]] = handle
        return out

    # ------------------------------------------------------------------
    # ops-plane surface
    # ------------------------------------------------------------------
    def _serving_snapshot(self) -> Dict[str, Any]:
        """The serving block of the ops-plane /health payload (and the
        master's /status): queue depth, occupancy, shed/timeout
        counters, and the age of the last completed loop step — the
        decode-stall watchdog's clock."""
        with self._lock:
            tier = self.engine.cache.host_tier
            tier_part = {} if tier is None else {
                "kv_host_free_frac": tier.free_blocks
                / max(1, tier.num_blocks),
                "kv_host_blocks": tier.num_blocks,
                "kv_parked_slots": len(self.engine.cache._slot_spill),
            }
            return {
                "queue_depth": len(self._queue),
                "active": len(self._active),
                "occupancy": self.engine.num_active
                / max(1, self.engine.max_seqs),
                "kv_free_frac": self.engine.cache.free_blocks
                / max(1, self.engine.cache.num_blocks),
                **tier_part,
                "steps": self.loop_steps,
                "step_age_s": round(
                    time.monotonic() - self._last_step_ts, 3),
                "shed": self.counters["shed"],
                "timeouts": self.counters["timeout"],
                "deadline_miss": self.counters["deadline_miss"],
                "completed": self.counters["completed"],
                "draining": self._draining,
            }

    def close(self) -> None:
        """Stop serving and restore SIGTERM."""
        if self._closed:
            return
        self._closed = True
        self.stop()
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
