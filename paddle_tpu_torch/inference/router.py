"""Disaggregated serving plane: a health-routed fleet of serving
hosts behind one request router (port of
``paddle_tpu/inference/router.py``).

One :class:`~paddle_tpu_torch.inference.server.GenerationServer` survives
overload and preemption; this module generalizes those semantics to a
FLEET:

* **ServingHost** — one named server with a role (``prefill`` |
  ``decode`` | ``unified``) and its own drive loop (a thread here; a
  process/pod in production). It registers with the launch master's
  ``/serve/register``, posts its /health serving block on a cadence
  (:func:`paddle_tpu_torch.observability.ops.post_host_health`), exports
  prefilled KV for handoff, and dies hard — no drain, no eviction —
  when the ``fault_serve_kill`` chaos hook fires, exactly like a host
  loss.
* **FleetRouter** — admits requests across hosts using each host's
  serving health block (queue depth, occupancy, shed pressure,
  ``step_age_s`` staleness) through smooth weighted round-robin:
  deterministic, and proportional to :meth:`FleetRouter.admission_weight`,
  so a degraded host gets proportionally fewer admissions instead of a
  hard cutoff. With a prefill pool present, a request's prompt runs on
  a prefill host, the filled KV pages move to a decode host
  (:mod:`paddle_tpu_torch.inference.kv_handoff` — the record itself
  between threaded hosts; between host processes device to device through
  the remote-copy kernel on CUDA hosts, the serialized path elsewhere),
  and decode continues without re-paying prefill.
* **failover** — the router keeps a per-request journal (prompt,
  sampling params, every token emitted). When a host dies, every one
  of its requests is replayed onto a survivor as prompt + emitted
  prefix; greedy decode is deterministic, so the continuation is
  bitwise what the dead host would have produced — zero token loss,
  and the journal's token cursor guarantees a token is never streamed
  twice. The death is reported to the master as DEFINITIVE incident
  evidence (``/serve/incident``) and the corpse is removed from the
  membership so the incident machine can measure a finite MTTR.

A request is fleet-admitted once ANY host takes it past its shed
gates; from then on the router never drops it — a shed on a later leg
(a handoff or failover landing on a momentarily full survivor) parks
the request in the journal and retries placement, because the client
was already promised the stream. Only the FIRST placement's shed
propagates (that is fleet-level admission control working as intended),
and a replay that can no longer meet its deadline answers
``deadline`` instead of burning survivor capacity on a dead request.

The port's one addition: a device-to-device handoff record names the
buffer its source host holds. When the router gives such a record up (the
request finished, its decode host died, or the pull was refused because
the source no longer holds it), it asks the source to discard the buffer
(``discard_handoff`` on the source's proxy), and a refused pull makes the
request replay from the journal instead of retrying the record. Two
counters account for those records: ``handoffs_refused`` (decode legs
whose pull was refused) and ``handoffs_dropped`` (unpulled records whose
decode host died, discarded on their source).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference.engine import GenerationRequest
from paddle_tpu_torch.inference.server import (HANDOFF_REFUSED,
                                               GenerationServer,
                                               RequestHandle)
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.testing import fault_injection

__all__ = ["ServingHost", "FleetRouter", "RouterHandle"]

_DECODE_ROLES = ("decode", "unified")


class ServingHost:
    """One serving host in the fleet: a named, role-tagged
    :class:`GenerationServer` with its own drive loop.

    The loop is the chaos surface: each iteration first consults
    ``fault_serve_kill`` — a triggered kill flips :attr:`alive` and
    exits the thread with NO cleanup (queued and active requests
    stranded, KV pages still allocated), which is what a host death
    looks like from the router's side. ``master_address`` opts into
    the ops plane: the host serve-registers on :meth:`start` and posts
    its serving health block every ``health_interval_s`` (dropped on
    the floor while ``fault_router_partition`` cuts this host's path).
    """

    def __init__(self, name: str, server: GenerationServer,
                 role: str = "unified",
                 master_address: Optional[str] = None,
                 health_interval_s: float = 0.05):
        if role not in ("prefill",) + _DECODE_ROLES:
            raise ValueError(f"unknown serving role {role!r}")
        self.name = name
        self.server = server
        self.role = role
        self.master_address = master_address
        self.health_interval_s = float(health_interval_s)
        self.alive = True
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # request_id -> sink(record, handle): prefill jobs to export
        # after their first emitted token (scanned on the loop thread,
        # which owns the engine — no cross-thread cache reads)
        self._handoff_sinks: Dict[Any, Callable] = {}
        self._last_health_post = 0.0

    # -- fleet visibility ------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """This host's /health serving block plus fleet identity — the
        router's admission input."""
        snap = self.server._serving_snapshot()
        snap["role"] = self.role
        snap["alive"] = self.alive
        return snap

    def _post_health(self, now: float) -> None:
        if now - self._last_health_post < self.health_interval_s:
            return
        if not self.master_address and not obs.enabled():
            return
        self._last_health_post = now
        snap = self.server._serving_snapshot()
        # the same serving block rides the metrics stream as a host-
        # labelled event for the offline fleet view (a no-op until that
        # stream is ported, ROADMAP.md A.12)
        obs.event("serve_host_health", host_name=self.name,
                  role=self.role, **snap)
        if not self.master_address:
            return
        from paddle_tpu_torch.observability import ops
        ops.post_host_health(self.master_address, self.name,
                             serving=snap, step=snap.get("steps"))

    # -- submission seams ------------------------------------------------
    def submit_prefill(self, request: GenerationRequest, sink: Callable,
                       timeout_s: Optional[float] = None,
                       deadline_s: Optional[float] = None) -> RequestHandle:
        """Run ``request`` as a prefill job: once its first token is
        out (prompt KV complete), the loop exports the pages, evicts
        the job (reason ``handoff`` — pages straight back to this
        host's free list), and calls ``sink(record, handle)``. A job
        that finishes WITHOUT exporting (eos on the first token, shed,
        expired) calls ``sink(None, handle)`` so the router can settle
        it from the handle."""
        handle = self.server.submit(request, timeout_s=timeout_s,
                                    deadline_s=deadline_s)
        self._handoff_sinks[request.request_id] = sink
        return handle

    # -- the hosted loop -------------------------------------------------
    def step(self) -> bool:
        """One loop iteration; False once this host is dead. The kill
        check runs FIRST so a killed host does no further work — not
        even the cleanup a drain would do."""
        if not self.alive:
            return False
        if fault_injection.serve_kill(self.name):
            self.alive = False
            return False
        self.server.step()
        self._export_scan()
        self._post_health(time.monotonic())
        return True

    def _export_scan(self) -> None:
        """Prefill-job watch (loop thread only): export + evict every
        job whose prompt is fully paged in — detected by its first
        emitted token — and hand the record to its sink."""
        if not self._handoff_sinks:
            return
        for rid in list(self._handoff_sinks):
            h = self.server.handles.get(rid)
            if h is None:
                self._handoff_sinks.pop(rid)(None, None)
                continue
            req = h.request
            if req.finished:
                # settled on this host (eos / shed / expired) before a
                # handoff could happen — the sink decides what it means
                self._handoff_sinks.pop(rid)(None, h)
            elif req.output_ids:
                tok = tracing.begin(getattr(req, "trace", None),
                                    "handoff.export", request_id=rid,
                                    host=self.name)
                rec = self.server.engine.export_request(rid)
                if rec is not None:
                    self.server.engine.evict(rid, "handoff")
                    # the wire record carries the trace so the decode
                    # host's install/decode spans join the same tree
                    # (the router overwrites with its decode-leg
                    # context at placement)
                    if tok is not None:
                        rec["trace"] = tracing.header(tracing.ctx_of(tok))
                    tracing.finish(tok, seq_len=rec.get("seq_len"))
                    self._handoff_sinks.pop(rid)(rec, h)
                else:
                    tracing.finish(tok, exported=False)

    def serve(self, poll_s: float = 0.001) -> None:
        """Drive the loop until :meth:`stop` or death. Health keeps
        posting while idle — post-incident recovery needs survivors to
        stay visibly live."""
        try:
            while not self._stop.is_set():
                if not self.step():
                    return
                if not self.server._pending():
                    time.sleep(poll_s)
        except BaseException:
            self.alive = False
            raise

    def start(self, poll_s: float = 0.001) -> "ServingHost":
        """Serve-register with the master (when configured) and start
        the loop thread."""
        if self.master_address:
            from paddle_tpu_torch.distributed.launch.master import \
                MasterClient
            MasterClient(self.master_address, self.name).serve_register(
                self.role)
        self._thread = threading.Thread(
            target=self.serve, kwargs={"poll_s": poll_s}, daemon=True,
            name=f"serving-host-{self.name}")
        self._thread.start()
        return self

    @property
    def started(self) -> bool:
        return self._thread is not None

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=10.0)

    def close(self) -> None:
        self.stop()
        self.server.close()


class _JournalEntry:
    """The router's authoritative record of one request: everything
    needed to replay it from scratch, plus every token already
    delivered (the dedup cursor — a token enters ``tokens`` exactly
    once, whichever host produced it)."""

    __slots__ = ("request_id", "prompt", "max_new", "temperature",
                 "top_k", "top_p", "eos_token_id", "seed", "tokens",
                 "state", "host", "handle", "legs", "record",
                 "deadline", "deadline_kind", "finish_reason", "error",
                 "submit_ts", "first_token_ts", "finish_ts",
                 "trace", "submit_wall", "pending_since")

    def __init__(self, request: GenerationRequest):
        self.request_id = request.request_id
        self.prompt = list(request.input_ids)
        self.max_new = int(request.max_new_tokens)
        self.temperature = request.temperature
        self.top_k = request.top_k
        self.top_p = request.top_p
        self.eos_token_id = request.eos_token_id
        self.seed = request.seed
        self.tokens: List[int] = []
        self.state = "pending"    # pending | prefill | decode | done
        self.host: Optional[str] = None
        self.handle: Optional[RequestHandle] = None
        self.legs = 0             # placements so far (1st shed = real shed)
        self.record: Optional[Dict[str, Any]] = None  # retryable handoff
        self.deadline: Optional[float] = None         # monotonic
        self.deadline_kind: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        # SLO clocks (monotonic): the load generator's TTFT/e2e
        # scoring reads these — router-level, so they span handoffs
        # and failovers the way a client would experience them
        self.submit_ts = time.monotonic()
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        # distributed-tracing root context (observability.tracing),
        # minted at admission; survives host deaths with the journal so
        # the failover replay leg joins the original trace
        self.trace = None
        self.submit_wall = time.time()
        self.pending_since: Optional[float] = None   # wall ts of a park

    def remaining_s(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()


class RouterHandle:
    """The client's view of one routed request: a stable token stream
    that survives handoffs and host deaths (the underlying per-host
    handles come and go; the journal's token list does not)."""

    def __init__(self, router: "FleetRouter", entry: _JournalEntry):
        self._router = router
        self._entry = entry
        self.request_id = entry.request_id

    @property
    def output_ids(self) -> List[int]:
        with self._router._lock:
            return list(self._entry.tokens)

    @property
    def done(self) -> bool:
        return self._entry.state == "done"

    @property
    def finish_reason(self) -> Optional[str]:
        return self._entry.finish_reason

    @property
    def host(self) -> Optional[str]:
        return self._entry.host

    @property
    def ttft_s(self) -> Optional[float]:
        """Router-observed time to first token (spans handoffs)."""
        ts = self._entry.first_token_ts
        return None if ts is None else ts - self._entry.submit_ts

    @property
    def e2e_s(self) -> Optional[float]:
        """Router-observed end-to-end latency once settled."""
        ts = self._entry.finish_ts
        return None if ts is None else ts - self._entry.submit_ts

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until the request settles (requires something to be
        driving :meth:`FleetRouter.poll` / ``run_until_idle``)."""
        with self._router._cond:
            if not self._router._cond.wait_for(
                    lambda: self._entry.state == "done", timeout=timeout):
                raise TimeoutError(
                    f"request {self.request_id} still running")
            return {"output_ids": list(self._entry.tokens),
                    "finish_reason": self._entry.finish_reason,
                    "error": self._entry.error}


class FleetRouter:
    """Health-routed admission + journaled failover across a fleet of
    :class:`ServingHost`\\ s. See the module docstring for the
    contract; the drills assert its strongest form — kill a decode
    host mid-stream and every admitted request still finishes with
    output bitwise-identical to an unkilled run.

    ``master_address`` connects the router to the launch master: host
    deaths open DEFINITIVE ``serve_host_down`` incidents and the
    corpse is removed from the membership (a dead serving loop cannot
    ``/leave`` itself), so the ops plane's MTTR clock runs."""

    def __init__(self, master_address: Optional[str] = None,
                 name: str = "router"):
        self.name = name
        self.master_address = master_address
        self.hosts: Dict[str, ServingHost] = {}
        self.journal: Dict[Any, _JournalEntry] = {}
        self.counters = {"submitted": 0, "completed": 0, "shed": 0,
                         "rejected": 0, "timeout": 0, "deadline_miss": 0,
                         "handoffs": 0, "failovers": 0, "failed_hosts": 0,
                         "replays_denied_deadline": 0,
                         "placements_failed": 0,
                         "cache_exhausted": 0,
                         "handoffs_refused": 0, "handoffs_dropped": 0}
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._swrr: Dict[str, float] = {}
        self._downed: set = set()
        self._master_client = None
        if master_address:
            from paddle_tpu_torch.distributed.launch.master import \
                MasterClient
            self._master_client = MasterClient(master_address, name)

    # -- fleet membership ------------------------------------------------
    def register_host(self, host: ServingHost) -> ServingHost:
        """Add (or REPLACE) a host. Re-registering a name that
        previously went down is a respawn rejoining the fleet: the
        name leaves the downed set so the new process's death would be
        detected again, and its SWRR ledger starts fresh."""
        with self._lock:
            self.hosts[host.name] = host
            self._downed.discard(host.name)
            self._swrr[host.name] = 0.0
        return host

    def deregister_host(self, name: str) -> bool:
        """Gracefully remove a host (elastic scale-down after a clean
        drain): no incident, no failover — its already-drained
        requests re-place through the normal pending path."""
        with self._lock:
            host = self.hosts.pop(name, None)
            self._swrr.pop(name, None)
            self._downed.discard(name)
        return host is not None

    def _live(self, roles: Tuple[str, ...]) -> List[ServingHost]:
        return [h for _, h in sorted(self.hosts.items())
                if h.alive and h.role in roles]

    # -- health-weighted admission ---------------------------------------
    @staticmethod
    def admission_weight(serving: Optional[Dict[str, Any]],
                         stale_after_s: float = 1.0) -> float:
        """Admission weight from one host's /health serving block —
        higher is more admissible. Queue depth, occupancy, and shed
        pressure each divide the weight (proportional back-off, never
        a cliff), and a stale ``step_age_s`` (the loop stopped
        completing steps — wedged or partitioned) decays it further.
        A host with NO health block is nearly-but-not-quite excluded:
        it still takes the odd request, which is how its health gets
        re-learned. A draining host is effectively excluded."""
        if not serving:
            return 1.0
        if serving.get("draining"):
            return 0.01
        w = 100.0
        w /= 1.0 + float(serving.get("queue_depth") or 0)
        w /= 1.0 + 4.0 * float(serving.get("occupancy") or 0.0)
        w /= 1.0 + float(serving.get("shed") or 0)
        age = serving.get("step_age_s")
        if age is not None and float(age) > stale_after_s:
            w /= 1.0 + (float(age) - stale_after_s)
        return max(w, 0.01)

    def _host_health(self, host: ServingHost) -> Optional[Dict[str, Any]]:
        # a partitioned host is invisible, not just degraded: the
        # router cannot read its health, so it weighs like an unknown
        if fault_injection.router_partitioned(host.name):
            return None
        try:
            return host.health()
        except Exception:                           # noqa: BLE001
            return None

    def _pick(self, candidates: List[ServingHost]) -> Optional[ServingHost]:
        """Smooth weighted round-robin over ``candidates`` (already
        name-sorted by :meth:`_live`): deterministic, spread
        proportionally to admission weight — the classic nginx
        algorithm, per-call weights re-read from live health."""
        if not candidates:
            return None
        weights = {h.name: self.admission_weight(self._host_health(h))
                   for h in candidates}
        total = sum(weights.values())
        for n, w in weights.items():
            self._swrr[n] = self._swrr.get(n, 0.0) + w
        best = max(candidates, key=lambda h: self._swrr[h.name])
        self._swrr[best.name] -= total
        return best

    # -- submission ------------------------------------------------------
    def submit(self, request: GenerationRequest,
               timeout_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> RouterHandle:
        """Admit a request into the fleet. With both a prefill pool
        and a decode pool live, the prompt runs on a prefill host and
        the KV pages hand off to a decode host; otherwise the request
        decodes where it lands. Never raises on overload — fleet-level
        shed shows up as ``finish_reason="shed"`` on the handle."""
        with self._lock:
            entry = _JournalEntry(request)
            entry.trace = tracing.mint(request.request_id)
            now = time.monotonic()
            if timeout_s is not None:
                entry.deadline = now + max(0.0, float(timeout_s))
                entry.deadline_kind = "timeout"
            if deadline_s is not None:
                dl = now + max(0.0, float(deadline_s) - time.time())
                if entry.deadline is None or dl < entry.deadline:
                    entry.deadline = dl
                    entry.deadline_kind = "deadline"
            self.journal[entry.request_id] = entry
            self.counters["submitted"] += 1
            prefills = self._live(("prefill",))
            decodes = self._live(_DECODE_ROLES)
            if prefills and decodes:
                self._start_prefill_locked(entry, self._pick(prefills))
            else:
                host = self._pick(decodes or prefills)
                if host is None:
                    self._finish_locked(entry, "shed",
                                        "no live serving host")
                else:
                    self._place_decode_locked(entry, host)
            return RouterHandle(self, entry)

    def _submit_kwargs(self, entry: _JournalEntry) -> Dict[str, Any]:
        rem = entry.remaining_s()
        if rem is None:
            return {}
        if entry.deadline_kind == "deadline":
            return {"deadline_s": time.time() + rem}
        return {"timeout_s": rem}

    def _start_prefill_locked(self, entry: _JournalEntry,
                              host: ServingHost) -> None:
        # the prefill job needs max_new_tokens=2: the export window
        # opens when the FIRST token is out, and a budget of 1 would
        # finish ("length") and free the pages in the same engine step
        # — the original budget rides in the journal and is restored
        # onto the handoff record
        clone = GenerationRequest(
            entry.request_id, list(entry.prompt), max_new_tokens=2,
            temperature=entry.temperature, top_k=entry.top_k,
            top_p=entry.top_p, eos_token_id=entry.eos_token_id,
            seed=entry.seed)
        entry.state = "prefill"
        entry.host = host.name
        entry.legs += 1
        tok = tracing.begin(entry.trace, "router.place",
                            request_id=entry.request_id, host=host.name,
                            role="prefill", leg=entry.legs)
        if tok is not None and not fault_injection.trace_drop():
            clone.trace = tracing.ctx_of(tok)
        try:
            entry.handle = host.submit_prefill(
                clone, functools.partial(self._prefill_done,
                                         entry.request_id),
                **self._submit_kwargs(entry))
            tracing.finish(tok)
        except Exception:                           # noqa: BLE001
            # the socket went dark mid-placement (a subprocess host
            # dying is exactly this): park the request; poll's dead-
            # host detection and _place_pending_locked retry it
            tracing.finish(tok, failed=True)
            self._park_failed_placement_locked(entry)

    def _place_decode_locked(self, entry: _JournalEntry,
                             host: ServingHost) -> None:
        """Place (or re-place) a decode leg: install a retryable
        handoff record when one is in hand, otherwise replay the
        journal (prompt + every emitted token as the new prompt;
        deterministic greedy decode continues bitwise)."""
        # a decode placement with no record in hand AFTER a first leg is
        # a journal replay (failover or a bounced leg) — its span name
        # distinguishes the replay leg in the reassembled trace
        replay = entry.record is None and entry.legs >= 1
        entry.legs += 1
        entry.state = "decode"
        entry.host = host.name
        if entry.pending_since is not None:
            # time the request sat parked in the journal waiting for a
            # live host — the router-side queue-wait seam
            tracing.record(entry.trace, "router.queue",
                           entry.pending_since,
                           (time.time() - entry.pending_since) * 1e3,
                           request_id=entry.request_id)
            entry.pending_since = None
        tok = tracing.begin(
            entry.trace, "router.replay" if replay else "router.place",
            request_id=entry.request_id, host=host.name, role="decode",
            leg=entry.legs,
            **({"replayed_tokens": len(entry.tokens)} if replay else {}))
        try:
            if entry.record is not None:
                rec = dict(entry.record)
                rec["max_new_tokens"] = entry.max_new
                if tok is not None:
                    if fault_injection.trace_drop():
                        # a dropped hop OMITS the context entirely —
                        # the record still carries the export leg's
                        # header, and forwarding that stale context
                        # would hide the drop from the reassembler
                        rec.pop("trace", None)
                    else:
                        rec["trace"] = tracing.header(
                            tracing.ctx_of(tok))
                entry.handle = host.server.submit_prefilled(
                    rec, **self._submit_kwargs(entry))
            else:
                req = GenerationRequest(
                    entry.request_id,
                    list(entry.prompt) + list(entry.tokens),
                    max_new_tokens=max(1,
                                       entry.max_new - len(entry.tokens)),
                    temperature=entry.temperature, top_k=entry.top_k,
                    top_p=entry.top_p, eos_token_id=entry.eos_token_id,
                    seed=entry.seed)
                if tok is not None and not fault_injection.trace_drop():
                    req.trace = tracing.ctx_of(tok)
                entry.handle = host.server.submit(
                    req, **self._submit_kwargs(entry))
                entry.handle._prior = list(entry.tokens)
            tracing.finish(tok)
        except Exception:                           # noqa: BLE001
            # transport failure placing onto a remote host (it died
            # between the liveness read and the POST): the record —
            # a serialized copy in router memory — survives; park the
            # entry and let the next poll place it on a survivor
            tracing.finish(tok, failed=True)
            self._park_failed_placement_locked(entry)

    def _park_failed_placement_locked(self, entry: _JournalEntry) -> None:
        entry.state = "pending"
        entry.handle = None
        entry.host = None
        entry.pending_since = time.time()
        self.counters["placements_failed"] += 1

    def _prefill_done(self, request_id, record, handle) -> None:
        """Sink for a prefill host's export scan (runs on that host's
        loop thread). ``record`` set: pages are in hand — pick a
        decode host and install. ``record`` None: the job settled on
        the prefill host; adopt its verdict, except a clone that
        merely ran out its 2-token budget continues as a journal
        replay (the export path was unavailable, not the request)."""
        with self._lock:
            entry = self.journal.get(request_id)
            if entry is None or entry.state != "prefill":
                return
            if record is not None:
                entry.record = record
                self._extend_tokens_locked(
                    entry, list(record.get("generated") or []))
                self.counters["handoffs"] += 1
                src = entry.host
                host = self._pick(self._live(_DECODE_ROLES))
                if host is None:
                    entry.state = "pending"     # placed by poll() later
                    entry.handle = None
                    entry.pending_since = time.time()
                else:
                    self._place_decode_locked(entry, host)
                if obs.enabled():
                    obs.inc("router_handoffs")
                    obs.event("router_handoff",
                              request_id=entry.request_id, src_host=src,
                              dst_host=None if host is None
                              else host.name)
                return
            if handle is None:
                self._finish_locked(entry, "shed", "prefill job vanished")
                return
            self._extend_tokens_locked(entry, handle.output_ids)
            reason = handle.finish_reason
            if reason == "eos" or len(entry.tokens) >= entry.max_new:
                self._finish_locked(entry, reason or "length",
                                    handle.request.error)
            elif reason == "length":
                # clone budget exhausted without an export window —
                # fall back to a plain replay on the decode pool
                entry.state = "pending"
                entry.handle = None
                entry.pending_since = time.time()
            else:
                self._finish_locked(entry, reason, handle.request.error)

    # -- journal bookkeeping ---------------------------------------------
    def _extend_tokens_locked(self, entry: _JournalEntry,
                              out: List[int]) -> None:
        # the dedup cursor: only the suffix beyond what the journal
        # already holds is appended, and never past the token budget —
        # a replayed host re-reporting the shared prefix is a no-op
        if len(out) > len(entry.tokens):
            delta = min(len(out), entry.max_new) - len(entry.tokens)
            entry.tokens = list(out[:entry.max_new])
            if entry.first_token_ts is None and entry.tokens:
                entry.first_token_ts = time.monotonic()
            if delta > 0:
                # token stream flush: the moment new tokens crossed from
                # a host handle into the client-visible journal stream
                tracing.record(entry.trace, "stream.flush", time.time(),
                               0.0, request_id=entry.request_id,
                               tokens=delta, host=entry.host)
            self._cond.notify_all()

    def _drop_record_locked(self, entry: _JournalEntry) -> bool:
        """Give up the entry's handoff record; a device-to-device record's
        source host discards the buffer it holds for it (a no-op once a
        decode host has pulled and released it). True when the source
        discarded a buffer."""
        rec, entry.record = entry.record, None
        ipc = (rec or {}).get("ipc")
        if ipc:
            discard = getattr(self.hosts.get(ipc.get("host")),
                              "discard_handoff", None)
            if discard is not None:
                return bool(discard(rec))
        return False

    def _finish_locked(self, entry: _JournalEntry, reason: str,
                       error: Optional[str] = None) -> None:
        entry.state = "done"
        entry.finish_ts = time.monotonic()
        entry.finish_reason = reason
        entry.error = error
        entry.handle = None
        self._drop_record_locked(entry)
        key = {"eos": "completed", "length": "completed",
               "shed": "shed", "rejected": "rejected",
               "timeout": "timeout", "deadline": "deadline_miss",
               "cache_exhausted": "cache_exhausted"}.get(reason)
        if key:
            self.counters[key] += 1
        # the request's ROOT span: every other span in the trace —
        # router legs, host admission, prefill chunks, handoff,
        # decode batches, the replay after a kill — hangs off this id
        tracing.record(entry.trace, "request", entry.submit_wall,
                       (entry.finish_ts - entry.submit_ts) * 1e3,
                       root=True, request_id=entry.request_id,
                       finish_reason=reason, tokens=len(entry.tokens),
                       legs=entry.legs)
        self._cond.notify_all()

    # -- failover --------------------------------------------------------
    def on_host_down(self, name: str) -> None:
        """A host died: report the incident (definitive evidence),
        remove the corpse from the membership, and fail every one of
        its journaled requests over to survivors — residual tokens the
        dead host computed but the router had not yet drained are
        recovered from its (still-readable) handles first, so the
        replay starts from the true frontier."""
        with self._lock:
            if name in self._downed:
                return
            self._downed.add(name)
            self.counters["failed_hosts"] += 1
            host = self.hosts.get(name)
            if host is not None:
                host.alive = False
        mc = self._master_client
        if mc is not None:
            try:
                mc.serve_incident(name, detail="serving loop dead")
                mc.leave_host(name)
            except Exception:                       # noqa: BLE001
                pass
        moved = 0
        with self._lock:
            for entry in self.journal.values():
                if entry.state == "done" or entry.host != name:
                    continue
                if entry.handle is not None:
                    self._extend_tokens_locked(entry,
                                               entry.handle.output_ids)
                entry.handle = None
                if self._drop_record_locked(entry):   # replay from journal
                    self.counters["handoffs_dropped"] += 1
                entry.host = None
                entry.state = "pending"
                entry.pending_since = time.time()
                self.counters["failovers"] += 1
                moved += 1
            self._place_pending_locked()
        if obs.enabled():
            obs.inc("router_failed_hosts")
            if moved:
                obs.inc("router_failovers", moved)
            obs.event("router_host_down", host_name=name,
                      failovers=moved)

    def _place_pending_locked(self) -> None:
        for entry in self.journal.values():
            if entry.state != "pending":
                continue
            if (entry.eos_token_id is not None and entry.tokens
                    and entry.tokens[-1] == entry.eos_token_id):
                self._finish_locked(entry, "eos")
                continue
            if len(entry.tokens) >= entry.max_new:
                self._finish_locked(entry, "length")
                continue
            rem = entry.remaining_s()
            if rem is not None and rem <= 0:
                # the replay cannot meet the client's deadline: answer
                # deadline/timeout now, don't burn survivor capacity
                self.counters["replays_denied_deadline"] += 1
                self._finish_locked(entry,
                                    entry.deadline_kind or "timeout",
                                    "expired before replay")
                continue
            host = self._pick(self._live(_DECODE_ROLES)
                              or self._live(("prefill",)))
            if host is None:
                continue                # nobody alive; keep journaled
            self._place_decode_locked(entry, host)

    # -- driving ---------------------------------------------------------
    def poll(self) -> None:
        """One router housekeeping pass: refresh remote proxies, detect
        dead hosts (their loop thread exited with
        :attr:`ServingHost.alive` down — for a subprocess host, the
        socket went dark or the process reaped), drain per-host handles
        into the journal, settle finished legs, and (re)place pending
        requests."""
        # refresh OUTSIDE the lock: a RemoteServingHost.refresh() is an
        # HTTP round trip plus possible handoff-sink callbacks that
        # take the lock themselves
        for h in list(self.hosts.values()):
            refresh = getattr(h, "refresh", None)
            if refresh is not None:
                try:
                    refresh()
                except Exception:                   # noqa: BLE001
                    pass
        with self._lock:
            dead = [n for n, h in self.hosts.items()
                    if h.started and not h.alive and n not in self._downed]
        for n in dead:
            self.on_host_down(n)
        with self._lock:
            for entry in list(self.journal.values()):
                if entry.state == "done" or entry.handle is None:
                    continue
                h = entry.handle
                self._extend_tokens_locked(entry, h.output_ids)
                if not h.done:
                    continue
                reason = h.request.finish_reason
                if reason == "handoff":
                    continue            # the decode leg is being placed
                if reason in ("eos", "length", "cache_exhausted",
                              "rejected", "timeout", "deadline"):
                    self._finish_locked(entry, reason, h.request.error)
                elif reason in ("shed", "drained"):
                    if entry.legs <= 1 and not entry.tokens:
                        # first placement shed: fleet admission control
                        self._finish_locked(entry, "shed",
                                            h.request.error)
                    else:
                        # a later leg bounced off a busy survivor: the
                        # request was already promised — park and retry
                        if (h.request.error or "").startswith(
                                HANDOFF_REFUSED):
                            # its record's pages are gone: replay
                            self.counters["handoffs_refused"] += 1
                            self._drop_record_locked(entry)
                        entry.handle = None
                        entry.state = "pending"
                        entry.host = None
                        entry.pending_since = time.time()
            self._place_pending_locked()

    def run_until_idle(self, timeout_s: float = 60.0,
                       poll_s: float = 0.002) -> bool:
        """Drive :meth:`poll` until every journaled request settles
        (the hosts' own threads do the decoding). True once idle;
        False when ``timeout_s`` elapses with requests outstanding."""
        deadline = time.monotonic() + timeout_s
        while True:
            self.poll()
            with self._lock:
                if all(e.state == "done"
                       for e in self.journal.values()):
                    return True
            if time.monotonic() > deadline:
                return False
            time.sleep(poll_s)

    # -- fleet stats -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Router counters plus each host's latest health."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "hosts": {n: self._host_health(h) or {"alive": h.alive}
                          for n, h in sorted(self.hosts.items())},
                "requests": len(self.journal),
                "open": sum(1 for e in self.journal.values()
                            if e.state != "done"),
            }

    def close(self) -> None:
        for h in self.hosts.values():
            h.close()
