"""Process-true serving fleet: real subprocess hosts behind the
:class:`~paddle_tpu_torch.inference.router.FleetRouter` (port of
``paddle_tpu/inference/fleet.py``).

* :class:`FleetSupervisor` spawns each host as a subprocess running
  :mod:`paddle_tpu_torch.distributed.launch.serve_host`, with the parent's
  chaos flags snapshotted into the child's environment
  (:func:`paddle_tpu_torch.testing.fault_injection.env_snapshot`) and the
  caller's ``env`` (numerics settings, flags) on top. Host death is a
  real ``SIGKILL`` or nonzero exit; recovery is a real respawn that
  re-registers with the launch master under the same name.
* :class:`RemoteServingHost` is the router-side proxy: it duck-types the
  :class:`~paddle_tpu_torch.inference.router.ServingHost` surface the
  router touches, but every operation crosses the child's loopback HTTP
  API — admission as JSON, the KV handoff as the packed wire record
  (:func:`~paddle_tpu_torch.inference.kv_handoff.pack_handoff`: the page
  bytes, or between CUDA hosts the descriptor of the source's exported
  buffer, which the decode host pulls device to device), token streaming
  as batched ``/requests`` polls. When a child dies, the proxy's last
  snapshot is the still-readable handle the journal replay recovers
  residual tokens from.

The contract under chaos is the threaded plane's: kill -9 a decode host
mid-stream and every admitted request still finishes, because the journal
replay and the deterministic decode live above the transport.

Not ported yet (A.11): :class:`ElasticityPolicy` and
:meth:`FleetSupervisor.autoscale_step` (the hysteresis-banded autoscaler,
with its forecast mode), and the per-host metrics streams (``obs_dir``,
A.12); each raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request as _urlreq
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.inference.engine import GenerationRequest
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.testing import fault_injection

__all__ = ["RemoteServingHost", "RemoteHandle", "FleetSupervisor",
           "ElasticityPolicy"]

# the checkout's root, which holds the paddle_tpu_torch package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --------------------------------------------------------------- proxy
class RemoteHandle:
    """Router-side view of one request living in a subprocess host.
    Mirrors the :class:`~paddle_tpu_torch.inference.server.RequestHandle`
    surface the router reads (``output_ids``/``done``/``finish_reason``
    plus ``request.finish_reason``/``request.error``), backed by the
    host's last ``/requests`` snapshot — still readable after the
    process dies, which is what the failover replay needs."""

    def __init__(self, request_id):
        self.request_id = request_id
        self.request = self          # .request.finish_reason/.error
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.done = False
        self._prior: List[int] = []
        self._tokens: List[int] = []

    @property
    def output_ids(self) -> List[int]:
        return self._prior + self._tokens

    def _update(self, snap: Dict[str, Any]) -> None:
        self._tokens = list(snap.get("output_ids") or [])
        self.done = bool(snap.get("done"))
        self.finish_reason = snap.get("finish_reason")
        self.error = snap.get("error")


class _RemoteServerProxy:
    """The ``host.server`` facade: the router submits decode legs
    through this exactly as it would to an in-process
    :class:`GenerationServer`, but the request crosses a socket."""

    def __init__(self, host: "RemoteServingHost"):
        self._host = host

    def submit(self, request: GenerationRequest,
               timeout_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> RemoteHandle:
        payload = {
            "request_id": str(request.request_id),
            "prompt": list(request.input_ids),
            "max_new_tokens": int(request.max_new_tokens),
            "temperature": request.temperature,
            "top_k": request.top_k,
            "top_p": request.top_p,
            "eos_token_id": request.eos_token_id,
            "seed": request.seed,
            "timeout_s": timeout_s,
            "deadline_s": deadline_s,
        }
        tr = tracing.header(getattr(request, "trace", None))
        if tr is not None:
            payload["trace"] = tr
        handle = self._host._track(request.request_id)
        self._host._post_json(
            "/submit", payload,
            headers={tracing.TRACE_HEADER: tr} if tr else None)
        return handle

    def submit_prefilled(self, record: Dict[str, Any],
                         timeout_s: Optional[float] = None,
                         deadline_s: Optional[float] = None
                         ) -> RemoteHandle:
        from paddle_tpu_torch.inference.kv_handoff import pack_handoff
        query = []
        if timeout_s is not None:
            query.append(f"timeout_s={float(timeout_s)}")
        if deadline_s is not None:
            query.append(f"deadline_s={float(deadline_s)}")
        path = "/submit_prefilled" + ("?" + "&".join(query)
                                      if query else "")
        tr = record.get("trace")
        handle = self._host._track(record["request_id"])
        t0 = time.perf_counter()
        self._host._post_bytes(
            path, pack_handoff(record),
            headers={tracing.TRACE_HEADER: tr} if tr else None)
        self._host.transfer["pushes"] += 1
        self._host.transfer["push_s"] += time.perf_counter() - t0
        return handle


class RemoteServingHost:
    """Socket-only proxy for one subprocess serving host. Quacks like
    :class:`~paddle_tpu_torch.inference.router.ServingHost` for everything
    the :class:`FleetRouter` touches; :meth:`refresh` (called from the
    router's poll pass) drains the child's batched ``/requests``
    snapshot into the tracked handles, collects ready handoff records,
    and detects death — a dead process (``proc.poll()`` nonzero) or a
    connection-refused streak flips :attr:`alive`, and the router's
    normal ``on_host_down`` path takes it from there."""

    DEAD_AFTER_ERRORS = 3

    def __init__(self, name: str, role: str, endpoint: str,
                 proc: Optional[subprocess.Popen] = None,
                 timeout_s: float = 10.0,
                 health_max_age_s: float = 0.25):
        self.name = name
        self.role = role
        self.endpoint = endpoint.rstrip("/")
        self.proc = proc
        self.alive = True
        self.started = True          # a spawned process IS started
        self.retiring = False        # drain in progress: errors expected
        self.timeout_s = float(timeout_s)
        self.server = _RemoteServerProxy(self)
        self._lock = threading.Lock()
        self._handles: Dict[str, RemoteHandle] = {}
        self._sinks: Dict[str, Callable] = {}
        self._errors = 0
        self._last_health: Optional[Dict[str, Any]] = None
        self._last_health_ts = 0.0
        self._health_max_age_s = float(health_max_age_s)
        # router-side wire time of handoff records: fetching from this
        # host (GET /handoff and unpack), pushing to it (pack and POST)
        self.transfer = {"fetches": 0, "fetch_s": 0.0, "pushes": 0,
                         "push_s": 0.0}

    # -- transport -----------------------------------------------------
    def _url(self, path: str) -> str:
        return self.endpoint + path

    def _post_json(self, path: str, payload: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> dict:
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        req = _urlreq.Request(
            self._url(path), data=json.dumps(payload).encode(),
            headers=hdrs)
        with _urlreq.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read())

    def _post_bytes(self, path: str, body: bytes,
                    headers: Optional[Dict[str, str]] = None) -> dict:
        hdrs = {"Content-Type": "application/octet-stream"}
        if headers:
            hdrs.update(headers)
        req = _urlreq.Request(self._url(path), data=body, headers=hdrs)
        with _urlreq.urlopen(req, timeout=self.timeout_s) as r:
            return json.loads(r.read())

    def _get_json(self, path: str) -> dict:
        with _urlreq.urlopen(self._url(path),
                             timeout=self.timeout_s) as r:
            return json.loads(r.read())

    def _get_bytes(self, path: str) -> bytes:
        with _urlreq.urlopen(self._url(path),
                             timeout=self.timeout_s) as r:
            return r.read()

    # -- ServingHost surface -------------------------------------------
    def _track(self, request_id) -> RemoteHandle:
        """Fresh handle for a NEW submission leg. Always replaces any
        prior handle under the same request id: a re-placed leg (jour-
        nal replay or record install after a failover) must not in-
        herit the previous leg's settled ``done``/``finish_reason`` —
        the router would read the stale terminal state as this leg's
        verdict."""
        rid = str(request_id)
        with self._lock:
            h = self._handles[rid] = RemoteHandle(request_id)
            return h

    def health(self) -> Dict[str, Any]:
        """Latest health block; served from the refresh-path cache when
        fresh so per-admission SWRR weight reads don't each pay an HTTP
        round trip."""
        now = time.monotonic()
        if (self._last_health is not None
                and now - self._last_health_ts < self._health_max_age_s):
            return self._last_health
        snap = self._get_json("/health")
        self._last_health, self._last_health_ts = snap, now
        return snap

    def submit_prefill(self, request: GenerationRequest, sink: Callable,
                       timeout_s: Optional[float] = None,
                       deadline_s: Optional[float] = None) -> RemoteHandle:
        handle = self._track(request.request_id)
        with self._lock:
            self._sinks[str(request.request_id)] = sink
        payload = {
            "request_id": str(request.request_id),
            "prompt": list(request.input_ids),
            "max_new_tokens": int(request.max_new_tokens),
            "temperature": request.temperature,
            "top_k": request.top_k,
            "top_p": request.top_p,
            "eos_token_id": request.eos_token_id,
            "seed": request.seed,
            "timeout_s": timeout_s,
            "deadline_s": deadline_s,
        }
        tr = tracing.header(getattr(request, "trace", None))
        if tr is not None:
            payload["trace"] = tr
        self._post_json(
            "/prefill", payload,
            headers={tracing.TRACE_HEADER: tr} if tr else None)
        return handle

    # -- the poll-pass hook --------------------------------------------
    def refresh(self) -> None:
        """Drain the child's state into the proxy: one batched
        ``/requests`` poll updates every tracked handle; ready handoff
        records are fetched (packed wire bytes → record) and delivered
        to their sinks, prefill jobs that settled without an export
        deliver ``sink(None, handle)`` — the same contract as the
        in-process export scan, driven from the router side of the
        socket."""
        if not self.alive:
            return
        if self.proc is not None and self.proc.poll() is not None:
            if not self.retiring:
                self.alive = False
            return
        try:
            snap = self._get_json("/requests")
            self._errors = 0
        except Exception:                           # noqa: BLE001
            self._errors += 1
            if self.proc is not None and self.proc.poll() is not None:
                if not self.retiring:
                    self.alive = False
            elif (self._errors >= self.DEAD_AFTER_ERRORS
                    and not self.retiring):
                self.alive = False
            return
        per_req = snap.get("requests") or {}
        fire: List[tuple] = []
        with self._lock:
            for rid, h in self._handles.items():
                st = per_req.get(rid)
                if st is None:
                    continue
                h._update(st)
                sink = self._sinks.get(rid)
                if sink is None:
                    continue
                if st.get("handoff_ready"):
                    self._sinks.pop(rid)
                    fire.append((rid, sink, h, True))
                elif st.get("prefill_settled") or (
                        h.done and h.finish_reason != "handoff"):
                    self._sinks.pop(rid)
                    fire.append((rid, sink, h, False))
        for rid, sink, h, ready in fire:
            record = None
            if ready:
                try:
                    from paddle_tpu_torch.inference.kv_handoff import \
                        unpack_handoff
                    t0 = time.perf_counter()
                    record = unpack_handoff(
                        self._get_bytes(f"/handoff?request_id={rid}"))
                    self.transfer["fetches"] += 1
                    self.transfer["fetch_s"] += time.perf_counter() - t0
                except Exception:                   # noqa: BLE001
                    record = None   # host died handoff-in-hand: replay
            try:
                sink(record, h)
            except Exception:                       # noqa: BLE001
                # one sink blowing up (it re-places the request, which
                # can cross a socket) must not abort the rest of the
                # batch — a lost sink is a request stuck forever
                pass
        if not snap.get("alive", True) and not self.retiring:
            # the child's serving loop died but the process has not
            # exited yet (chaos kill mid-teardown) — same verdict
            self.alive = False

    def introspect(self) -> Dict[str, Any]:
        """KV-pool accounting straight from the child engine (the
        zero-page-leak assertions read this), with its parameter digest,
        kernel launch counts, handoff counters and IPC buffers held."""
        return self._get_json("/introspect")

    def discard_handoff(self, record: Dict[str, Any]) -> bool:
        """Ask this (source) host to drop the device buffer a
        device-to-device record names; False when it no longer holds it
        or cannot be reached."""
        try:
            return bool(self._post_json("/ipc/discard", {
                "generation": record["ipc"]["generation"]}).get("ok"))
        except Exception:                           # noqa: BLE001
            return False

    # -- lifecycle (the supervisor owns the process) -------------------
    def drain(self) -> bool:
        try:
            self.retiring = True
            self._post_json("/drain", {})
            return True
        except Exception:                           # noqa: BLE001
            return False

    def shutdown(self) -> bool:
        try:
            self.retiring = True
            self._post_json("/shutdown", {})
            return True
        except Exception:                           # noqa: BLE001
            return False

    def stop(self) -> None:          # router.close() surface
        pass

    def close(self) -> None:
        pass


# ---------------------------------------------------------- supervisor
class ElasticityPolicy:
    """The hysteresis-banded autoscale policy over the decode pool's
    /health blocks (and its forecast mode): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ElasticityPolicy (and FleetSupervisor.autoscale_step, the "
            "forecast mode) is not ported to paddle_tpu_torch yet "
            "(ROADMAP.md A.11)")


class FleetSupervisor:
    """Spawn, watch, kill, respawn, and autoscale subprocess serving
    hosts. One supervisor owns one fleet's processes; the
    :class:`FleetRouter` owns admission and failover — the supervisor
    hands it :class:`RemoteServingHost` proxies and otherwise stays
    out of the data path.

    ``spec`` is the deterministic host spec every child builds from
    (see :func:`paddle_tpu_torch.distributed.launch.serve_host.
    build_from_spec`). At spawn the parent's armed chaos flags are
    snapshotted into the child env (``FLAGS_fault_*``), so drills armed
    with :func:`fault_injection.inject` reach real child processes;
    ``env`` adds the caller's variables on top (numerics settings such
    as ``CUBLAS_WORKSPACE_CONFIG``). ``log_dir`` keeps
    each child's output in ``<log_dir>/<name>.log``. ``obs_dir`` (the
    per-host metrics streams) is not ported (A.12)."""

    def __init__(self, master_address: str, spec: Dict[str, Any],
                 obs_dir: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 poll_s: float = 0.002,
                 health_interval_s: float = 0.05,
                 spawn_timeout_s: float = 90.0):
        if obs_dir is not None:
            raise NotImplementedError(
                "FleetSupervisor(obs_dir=...): the per-host metrics "
                "streams are not ported to paddle_tpu_torch yet "
                "(ROADMAP.md A.12)")
        self.master_address = master_address.rstrip("/")
        self.spec = dict(spec)
        self.log_dir = log_dir
        self.env_overrides = dict(env or {})
        self.poll_s = float(poll_s)
        self.health_interval_s = float(health_interval_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.hosts: Dict[str, RemoteServingHost] = {}
        self.procs: Dict[str, subprocess.Popen] = {}
        self.roles: Dict[str, str] = {}
        self.counters = {"spawned": 0, "killed": 0, "respawned": 0,
                         "retired": 0}
        self._logs: List[Any] = []

    # -- spawning ------------------------------------------------------
    def _child_env(self, name: str) -> Dict[str, str]:
        env = dict(os.environ)
        # the child imports this checkout's package, wherever it runs
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        # the chaos snapshot: runtime-armed fault flags cross the
        # process boundary as FLAGS_* env vars the child's registry
        # reads at import
        env.update(fault_injection.env_snapshot())
        env.update(self.env_overrides)
        return env

    def spawn(self, name: str, role: str,
              wait_ready: bool = True) -> RemoteServingHost:
        """Launch one subprocess host and (by default) block until it
        serve-registered its bound endpoint with the master and its
        /health answers. Returns the router-ready proxy."""
        if name in self.procs and self.procs[name].poll() is None:
            raise ValueError(f"host {name!r} is already running")
        cmd = [sys.executable, "-m",
               "paddle_tpu_torch.distributed.launch.serve_host",
               "--name", name, "--role", role,
               "--master", self.master_address,
               "--spec", json.dumps(self.spec),
               "--poll-s", str(self.poll_s),
               "--health-interval-s", str(self.health_interval_s)]
        stdout = stderr = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            log = open(os.path.join(self.log_dir, f"{name}.log"), "ab")
            self._logs.append(log)
            stdout = stderr = log
        proc = subprocess.Popen(cmd, env=self._child_env(name),
                                stdout=stdout, stderr=stderr)
        self.procs[name] = proc
        self.roles[name] = role
        self.counters["spawned"] += 1
        host = RemoteServingHost(name, role, "pending:", proc=proc)
        self.hosts[name] = host
        if wait_ready:
            self.wait_ready(name)
        return host

    def wait_ready(self, name: str,
                   timeout_s: Optional[float] = None) -> RemoteServingHost:
        """Block until ``name`` appears in the master's /serve/fleet
        with a live endpoint whose /health answers."""
        deadline = time.monotonic() + (timeout_s
                                       or self.spawn_timeout_s)
        host = self.hosts[name]
        proc = self.procs.get(name)
        while True:
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"host {name!r} exited with code "
                    f"{proc.returncode} before becoming ready")
            try:
                fleet = self._serve_fleet()
                info = fleet.get("hosts", {}).get(name)
                if info and info.get("endpoint"):
                    host.endpoint = info["endpoint"].rstrip("/")
                    host.health()          # one live round trip
                    return host
            except Exception:                       # noqa: BLE001
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"host {name!r} not serving after "
                    f"{timeout_s or self.spawn_timeout_s}s")
            time.sleep(0.05)

    def _serve_fleet(self) -> dict:
        with _urlreq.urlopen(self.master_address + "/serve/fleet",
                             timeout=5.0) as r:
            return json.loads(r.read())

    # -- chaos + recovery ----------------------------------------------
    def kill(self, name: str, sig: int = signal.SIGKILL) -> None:
        """A real host death: SIGKILL by default — no drain, no leave,
        no cleanup. The router detects it through the socket going
        dark and the supervisor through ``proc.poll()``."""
        proc = self.procs.get(name)
        if proc is None or proc.poll() is not None:
            return
        proc.send_signal(sig)
        proc.wait(timeout=30.0)
        self.counters["killed"] += 1

    def respawn(self, name: str,
                router=None) -> RemoteServingHost:
        """Bring a dead host back: a fresh process under the SAME name
        re-registers with the master (taking its rank back — the ops
        incident machine counts the re-register as recovery) and
        replaces the corpse's proxy in the router's membership."""
        proc = self.procs.get(name)
        if proc is not None and proc.poll() is None:
            raise ValueError(f"host {name!r} is still running")
        role = self.roles[name]
        self.procs.pop(name, None)
        self.hosts.pop(name, None)
        host = self.spawn(name, role)
        self.counters["respawned"] += 1
        if router is not None:
            router.register_host(host)
        return host

    def ensure(self, router=None) -> List[str]:
        """Respawn every host whose process died (the elasticity
        loop's repair half: the fleet converges back to its target
        shape after any number of kills). Returns respawned names."""
        out = []
        for name, proc in list(self.procs.items()):
            if proc.poll() is not None \
                    and not self.hosts[name].retiring:
                self.respawn(name, router=router)
                out.append(name)
        return out

    # -- elasticity ----------------------------------------------------
    def live_hosts(self, role: Optional[str] = None
                   ) -> List[RemoteServingHost]:
        return [h for n, h in sorted(self.hosts.items())
                if h.alive and not h.retiring
                and (role is None or h.role == role)
                and self.procs.get(n) is not None
                and self.procs[n].poll() is None]

    def autoscale_step(self, policy, router=None) -> Optional[str]:
        """One autoscale tick: not ported yet (ROADMAP.md A.11)."""
        raise NotImplementedError(
            "FleetSupervisor.autoscale_step is not ported to "
            "paddle_tpu_torch yet (ROADMAP.md A.11)")

    def retire(self, name: str, router=None,
               timeout_s: float = 60.0) -> bool:
        """Graceful scale-down of one host: POST /drain, wait for the
        clean exit, remove it from the router membership."""
        host = self.hosts.get(name)
        proc = self.procs.get(name)
        if host is None or proc is None:
            return False
        host.drain()
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10.0)
        if router is not None:
            router.deregister_host(name)
        self.hosts.pop(name, None)
        self.procs.pop(name, None)
        self.roles.pop(name, None)
        self.counters["retired"] += 1
        return True

    # -- teardown ------------------------------------------------------
    def close(self, timeout_s: float = 15.0) -> None:
        for name, host in list(self.hosts.items()):
            proc = self.procs.get(name)
            if proc is not None and proc.poll() is None:
                host.shutdown()
        deadline = time.monotonic() + timeout_s
        for name, proc in list(self.procs.items()):
            if proc.poll() is None:
                try:
                    proc.wait(timeout=max(0.1, deadline
                                          - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10.0)
        for log in self._logs:
            try:
                log.close()
            except Exception:                       # noqa: BLE001
                pass
        self._logs.clear()
