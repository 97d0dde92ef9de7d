"""Cluster master: membership and the serving fleet's ops plane (port of
``paddle_tpu/distributed/launch/master.py``).

Pure stdlib (``http.server`` and threads). What the serving fleet uses is
ported:

* membership: ``/register``, ``/heartbeat``, ``/leave``, ``/peers``,
  ``/generation``, a heartbeat TTL sweep with the tighter ``serve_ttl`` for
  serving hosts (a SIGKILLed host never sends ``/leave``);
* ``/health`` reports (a serving host's health block, which doubles as its
  heartbeat), ``/status``;
* the serving plane: ``/serve/register`` (a host joins with a role),
  ``/serve/fleet`` (the router's admission view), ``/serve/incident`` (a
  router-observed host death) and :meth:`MasterClient.leave_host`;
* the incident machine as far as a ``serve_host_down`` incident goes:
  opened on definitive evidence, declared at once, its evidence collected
  after ``ops_bundle_grace``, a restart issued (the generation bump), and
  recovered, with ``mttr_seconds``, once every current peer re-registered
  or reported health after the restart; ``/incidents`` and
  :meth:`MasterClient.incidents` read it.

The training ops plane waits for ROADMAP.md A.12: hang detection from step
progress (the ``progress_overdue`` and stall evidence), debug-bundle upload
and diagnosis through the flight recorder (``/bundle`` answers 404,
:meth:`MasterClient.upload_bundle` raises), and ``state_path`` persistence,
``bundle_dir`` and ``incident_log`` (the constructor raises for each).
"""

from __future__ import annotations

import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib import request as _urlreq
from urllib.error import HTTPError, URLError

__all__ = ["HTTPMaster", "MasterClient", "INCIDENT_STATES"]

# the incident state machine, in order; every transition is stamped with a
# wall-clock ts so recovered incidents carry mttr_seconds
INCIDENT_STATES = ("suspect", "hang_declared", "bundles_collected",
                   "restart_issued", "recovered")


def _unported(what: str):
    return NotImplementedError(
        f"HTTPMaster: {what} belongs to the training ops plane, not ported "
        f"to paddle_tpu_torch yet (ROADMAP.md A.12)")


class HTTPMaster:
    """Rendezvous and membership server, and the serving fleet's ops plane
    (see the module docstring for the endpoints)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ttl: float = 10.0, state_path: Optional[str] = None,
                 ops_hang_after: float = 30.0,
                 ops_bundle_grace: float = 5.0,
                 ops_poll: float = 0.0,
                 ops_auto_restart: bool = True,
                 bundle_dir: Optional[str] = None,
                 incident_log: Optional[str] = None,
                 serve_ttl: Optional[float] = None):
        """``ops_hang_after``: seconds a suspect incident without
        definitive evidence waits before it is declared. ``ops_bundle_grace``:
        after the declaration, how long to wait before collecting.
        ``ops_poll`` > 0 runs a monitor thread, so incidents progress while
        no node talks to the master. ``ops_auto_restart``: issue the
        restart (the generation bump) once collected; off, an operator
        calls :meth:`ops_issue_restart`. ``serve_ttl``: the liveness TTL of
        serving-registered peers (default ``ttl``)."""
        if state_path is not None:
            raise _unported("state_path persistence")
        if bundle_dir is not None or incident_log is not None:
            raise _unported("bundle_dir and incident_log")
        self._lock = threading.Lock()
        self._peers: Dict[str, dict] = {}   # name -> {endpoint, rank,
                                            #          last_beat, role?}
        self._generation = 0
        self._ttl = float(ttl)
        self._serve_ttl = float(serve_ttl) if serve_ttl is not None \
            else float(ttl)
        self._ops_hang_after = float(ops_hang_after)
        self._ops_bundle_grace = float(ops_bundle_grace)
        self._ops_auto_restart = bool(ops_auto_restart)
        self._health: Dict[str, dict] = {}   # name -> {payload, ts, step}
        self._incident: Optional[dict] = None
        self._incidents: List[dict] = []
        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # silence per-request spam
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                master._sweep()
                if self.path == "/peers":
                    with master._lock:
                        self._json(200, {
                            "peers": {n: p["endpoint"]
                                      for n, p in master._peers.items()},
                            "generation": master._generation})
                elif self.path == "/generation":
                    with master._lock:
                        self._json(200,
                                   {"generation": master._generation})
                elif self.path == "/status":
                    self._json(200, master._status())
                elif self.path == "/incidents":
                    self._json(200, master._incident_view())
                elif self.path == "/serve/fleet":
                    self._json(200, master._serve_fleet())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                master._sweep()   # expired peers free their ranks
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "bad json"})
                    return
                if self.path == "/register":
                    out = master._register(payload)
                    self._json(400 if "error" in out else 200, out)
                elif self.path == "/heartbeat":
                    self._json(200, master._beat(payload))
                elif self.path == "/leave":
                    self._json(200, master._leave(payload))
                elif self.path == "/health":
                    out = master._health_report(payload)
                    self._json(400 if "error" in out else 200, out)
                elif self.path == "/serve/register":
                    out = master._serve_register(payload)
                    self._json(400 if "error" in out else 200, out)
                elif self.path == "/serve/incident":
                    out = master._serve_incident(payload)
                    self._json(400 if "error" in out else 200, out)
                else:
                    # /bundle (debug-bundle upload) is A.12's
                    self._json(404, {"error": "unknown path"})

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_port
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._ops_stop = threading.Event()
        self._ops_thread: Optional[threading.Thread] = None
        if ops_poll > 0:
            self._ops_thread = threading.Thread(
                target=self._ops_monitor, args=(float(ops_poll),),
                name="ops-monitor", daemon=True)
            self._ops_thread.start()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- membership ----------------------------------------------------------
    def _register(self, payload):
        name = payload.get("name")
        if not name:
            return {"error": "register needs a name"}
        with self._lock:
            peer = self._peers.get(name)
            if peer is None:
                # the lowest free rank: a replacement takes its rank back
                used = {p["rank"] for p in self._peers.values()}
                rank = 0
                while rank in used:
                    rank += 1
                peer = {"endpoint": payload.get("endpoint", ""),
                        "rank": rank,
                        "last_beat": time.time(),
                        "last_register": time.time()}
                self._peers[name] = peer
                self._generation += 1
            else:
                peer["last_beat"] = time.time()
                # a re-register after a restart is post-restart liveness
                peer["last_register"] = time.time()
            coord = next((p["endpoint"] for p in self._peers.values()
                          if p["rank"] == 0), "")
            return {"rank": peer["rank"], "coordinator": coord,
                    "generation": self._generation,
                    "world": len(self._peers)}

    def _beat(self, payload):
        with self._lock:
            peer = self._peers.get(payload.get("name"))
            if peer is not None:
                peer["last_beat"] = time.time()
            return {"generation": self._generation}

    def _leave(self, payload):
        with self._lock:
            if self._peers.pop(payload.get("name"), None) is not None:
                self._generation += 1
            return {"generation": self._generation}

    def _sweep(self):
        """Drop peers whose heartbeat exceeded the TTL; serving peers
        (those with a role) on ``serve_ttl``."""
        now = time.time()
        with self._lock:
            stale = [n for n, p in self._peers.items()
                     if now - p["last_beat"]
                     > (self._serve_ttl if "role" in p else self._ttl)]
            for n in stale:
                del self._peers[n]
            if stale:
                self._generation += 1

    @property
    def generation(self) -> int:
        self._sweep()
        with self._lock:
            return self._generation

    # -- operations plane ----------------------------------------------------
    def _health_report(self, payload):
        name = payload.get("name")
        if not name:
            return {"error": "health needs a name"}
        now = time.time()
        with self._lock:
            h = self._health.setdefault(name, {"step": None})
            if payload.get("step") is not None:
                h["step"] = payload["step"]
            h["payload"] = payload
            h["ts"] = now
            peer = self._peers.get(name)
            if peer is not None:      # health doubles as a heartbeat
                peer["last_beat"] = now
            self._ops_eval_locked(now)
            out = {"generation": self._generation}
            if self._incident is not None:
                out["incident"] = {"id": self._incident["id"],
                                   "state": self._incident["state"]}
            return out

    def _ops_open_locked(self, now, kind, name, **detail):
        """Record one piece of evidence, opening an incident (``suspect``,
        ``detected_ts`` now) when none is in flight."""
        if self._incident is None:
            self._incident = {
                "id": len(self._incidents) + 1,
                "state": "suspect",
                "detected_ts": now,
                "transitions": [{"state": "suspect", "ts": now}],
                "evidence": [],
                "suspects": [],
                "diagnosis": None,
                "generation_before": self._generation,
                "mttr_seconds": None,
            }
        inc = self._incident
        ev = {"kind": kind, "name": name, "ts": now}
        ev.update({k: v for k, v in detail.items() if v is not None})
        inc["evidence"].append(ev)
        if name and name not in inc["suspects"]:
            inc["suspects"].append(name)
        return inc

    def _ops_transition_locked(self, inc, state, now):
        inc["state"] = state
        inc["transitions"].append({"state": state, "ts": now})

    def _ops_eval_locked(self, now):
        """Advance the open incident as far as the evidence allows."""
        inc = self._incident
        if inc is None:
            return
        if inc["state"] == "suspect":
            # a router-observed host death is definitive: declare now
            definitive = any(e["kind"] == "serve_host_down"
                             for e in inc["evidence"])
            if definitive \
                    or now - inc["detected_ts"] >= self._ops_hang_after:
                self._ops_transition_locked(inc, "hang_declared", now)
        if inc["state"] == "hang_declared":
            if now - inc["transitions"][-1]["ts"] >= self._ops_bundle_grace:
                # no bundles to diagnose (A.12): the evidence is the record
                inc["diagnosis"] = {"verdict": "serving host down",
                                    "suspects": list(inc["suspects"])}
                self._ops_transition_locked(inc, "bundles_collected", now)
        if inc["state"] == "bundles_collected" and self._ops_auto_restart:
            self._ops_issue_restart_locked(inc, now)
        if inc["state"] == "restart_issued":
            rts = inc["restart_ts"]
            if self._peers and all(self._ops_peer_ok_locked(n, rts)
                                   for n in self._peers):
                self._ops_transition_locked(inc, "recovered", now)
                inc["recovered_ts"] = now
                inc["mttr_seconds"] = now - inc["detected_ts"]
                self._incidents.append(inc)
                self._incident = None

    def _ops_issue_restart_locked(self, inc, now):
        self._generation += 1
        inc["generation_after"] = self._generation
        inc["restart_ts"] = now
        self._ops_transition_locked(inc, "restart_issued", now)

    def ops_issue_restart(self) -> bool:
        """Push the open incident from bundles_collected to restart_issued
        (``ops_auto_restart=False``); False when none is in that state."""
        now = time.time()
        with self._lock:
            inc = self._incident
            if inc is None or inc["state"] != "bundles_collected":
                return False
            self._ops_issue_restart_locked(inc, now)
            return True

    def _ops_peer_ok_locked(self, name, restart_ts) -> bool:
        """Post-restart liveness: re-registered or reported health since
        the restart."""
        p = self._peers.get(name)
        if p and p.get("last_register", 0.0) > restart_ts:
            return True
        h = self._health.get(name)
        return bool(h and h.get("ts", 0.0) > restart_ts)

    def _ops_monitor(self, poll: float):
        while not self._ops_stop.wait(poll):
            self._sweep()
            with self._lock:
                self._ops_eval_locked(time.time())

    def _status(self) -> Dict[str, Any]:
        now = time.time()
        with self._lock:
            peers = {}
            for n, p in self._peers.items():
                h = self._health.get(n, {})
                peers[n] = {"rank": p["rank"],
                            "beat_age_s": round(now - p["last_beat"], 3),
                            "step": h.get("step")}
                serving = (h.get("payload") or {}).get("serving")
                if serving:
                    peers[n]["serving"] = {
                        k: serving.get(k) for k in (
                            "queue_depth", "active", "occupancy",
                            "shed", "timeouts", "deadline_miss",
                            "completed", "step_age_s", "draining")
                        if k in serving}
            out = {"generation": self._generation,
                   "world": len(self._peers),
                   "peers": peers,
                   "incidents_total": len(self._incidents),
                   "incident": None}
            if self._incident is not None:
                inc = self._incident
                out["incident"] = {
                    "id": inc["id"], "state": inc["state"],
                    "suspects": list(inc["suspects"]),
                    "detected_ts": inc["detected_ts"],
                    "diagnosis": inc.get("diagnosis")}
            return out

    def _incident_view(self) -> Dict[str, Any]:
        with self._lock:
            return {"open": self._incident,
                    "incidents": list(self._incidents)}

    # -- serving plane -------------------------------------------------------
    def _serve_register(self, payload):
        """A serving host joins with a role (prefill | decode |
        unified)."""
        role = str(payload.get("role", "unified")).lower()
        if role not in ("prefill", "decode", "unified"):
            return {"error": f"unknown serving role {role!r}"}
        out = self._register(payload)
        if "error" in out:
            return out
        with self._lock:
            peer = self._peers.get(payload.get("name"))
            if peer is not None:
                peer["role"] = role
        out["role"] = role
        return out

    def _serve_fleet(self):
        """The router's admission view: every serving peer with its role,
        liveness ages and latest serving health block."""
        now = time.time()
        with self._lock:
            hosts = {}
            for n, p in self._peers.items():
                if "role" not in p:
                    continue          # a training peer, not a server
                h = self._health.get(n, {})
                payload = h.get("payload") or {}
                hosts[n] = {
                    "role": p["role"],
                    "rank": p["rank"],
                    "endpoint": p.get("endpoint", ""),
                    "beat_age_s": round(now - p["last_beat"], 3),
                    "health_age_s": (round(now - h["ts"], 3)
                                     if h.get("ts") else None),
                    "serving": payload.get("serving"),
                }
            return {"generation": self._generation, "hosts": hosts}

    def _serve_incident(self, payload):
        """A router-observed host death: definitive evidence, so the
        incident is declared at once."""
        host = payload.get("host")
        if not host:
            return {"error": "serve incident needs a host"}
        now = time.time()
        with self._lock:
            inc = self._ops_open_locked(
                now, "serve_host_down", host,
                reporter=payload.get("name"),
                detail=payload.get("detail"))
            self._ops_eval_locked(now)
            return {"incident": inc["id"], "state": inc["state"]}

    def shutdown(self):
        self._ops_stop.set()
        if self._ops_thread is not None:
            self._ops_thread.join(timeout=5.0)
        self._server.shutdown()
        self._server.server_close()


class MasterClient:
    """Node-side client of :class:`HTTPMaster`."""

    def __init__(self, address: str, name: str, endpoint: str = "",
                 timeout: float = 5.0):
        self.address = address.rstrip("/")
        self.name = name
        self.endpoint = endpoint
        self.timeout = timeout
        self._beat_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _call(self, path: str, payload: Optional[dict] = None,
              attempts: int = 3) -> dict:
        """One round trip, retried with backoff on transport failures; an
        ``HTTPError`` is an answer from a live master and propagates."""
        delay = 0.1
        for attempt in range(1, attempts + 1):
            try:
                if payload is None:
                    req = _urlreq.Request(self.address + path)
                else:
                    req = _urlreq.Request(
                        self.address + path,
                        data=json.dumps(payload).encode(),
                        headers={"Content-Type": "application/json"})
                with _urlreq.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
            except HTTPError:
                raise
            except (URLError, OSError):
                if attempt == attempts:
                    raise
                time.sleep(delay * (1.0 + 0.5 * random.random()))
                delay = min(2 * delay, 1.0)
        raise AssertionError("unreachable")

    def register(self, world: int = 0) -> dict:
        return self._call("/register", {"name": self.name,
                                        "endpoint": self.endpoint,
                                        "world": world})

    def wait_for_world(self, world: int, timeout: float = 60.0) -> dict:
        """Block until ``world`` peers are registered."""
        deadline = time.time() + timeout
        while True:
            info = self._call("/peers")
            if len(info["peers"]) >= world:
                return info
            if time.time() > deadline:
                raise TimeoutError(
                    f"rendezvous: {len(info['peers'])}/{world} nodes "
                    f"after {timeout}s")
            time.sleep(0.2)

    def heartbeat_forever(self, interval: float = 2.0):
        """Background heartbeat keeping this node in the membership."""
        def beat():
            while not self._stop.wait(interval):
                try:
                    self._call("/heartbeat", {"name": self.name})
                except Exception:                   # noqa: BLE001
                    pass
        self._beat_thread = threading.Thread(target=beat, daemon=True)
        self._beat_thread.start()

    def generation(self) -> int:
        return int(self._call("/generation")["generation"])

    def health(self, payload: Optional[dict] = None, **fields) -> dict:
        """POST one health report for this node."""
        body = dict(payload or {})
        body.update(fields)
        body.setdefault("name", self.name)
        return self._call("/health", body)

    def upload_bundle(self, bundle: dict) -> dict:
        raise _unported("debug-bundle upload")

    def status(self) -> dict:
        return self._call("/status")

    def incidents(self) -> dict:
        return self._call("/incidents")

    # -- serving plane -------------------------------------------------------
    def serve_register(self, role: str = "unified") -> dict:
        """Join the serving fleet with a role."""
        return self._call("/serve/register", {"name": self.name,
                                              "endpoint": self.endpoint,
                                              "role": role})

    def serve_fleet(self) -> dict:
        return self._call("/serve/fleet")

    def serve_incident(self, host: str, detail: Optional[str] = None
                       ) -> dict:
        """Report a router-observed serving-host death."""
        return self._call("/serve/incident", {"name": self.name,
                                              "host": host,
                                              "detail": detail})

    def leave_host(self, host: str) -> dict:
        """Remove a dead host from the membership on its behalf."""
        return self._call("/leave", {"name": host})

    def stop_heartbeat(self):
        self._stop.set()
        t = self._beat_thread
        if t is not None and t.is_alive():
            t.join(timeout=self.timeout + 1.0)
        self._beat_thread = None

    def leave(self):
        self.stop_heartbeat()
        try:
            self._call("/leave", {"name": self.name})
        except Exception:                           # noqa: BLE001
            pass
