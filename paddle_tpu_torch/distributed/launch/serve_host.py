"""Per-host subprocess entry point of the process-true serving fleet (port
of ``paddle_tpu/distributed/launch/serve_host.py``).

``python -m paddle_tpu_torch.distributed.launch.serve_host --name dc0
--role decode --master http://127.0.0.1:PORT --spec '<json>'`` builds a
model, a :class:`~paddle_tpu_torch.inference.engine.GenerationEngine` and a
:class:`~paddle_tpu_torch.inference.server.GenerationServer` in a fresh OS
process, binds a loopback HTTP API, serve-registers the bound endpoint with
the launch master, and drives the serving loop on the MAIN thread, so the
exit code is the loop's fate:

* exit 0: a supervisor ``/shutdown``, a graceful ``/drain``, or the parent
  process gone (the loop watches ``os.getppid()``, so a hard-killed
  supervisor leaks no spinning hosts);
* exit 86: the serving loop died (an armed ``fault_serve_kill`` /
  ``fault_serve_step``, or any crash).

HTTP API (the router-side proxy, :class:`paddle_tpu_torch.inference.fleet.
RemoteServingHost`, talks through nothing else):

* ``POST /submit``            JSON request -> decode/unified admission
* ``POST /prefill``           JSON request -> prefill job; its exported
  record parks in an outbox (``GET /handoff`` collects it)
* ``POST /submit_prefilled``  a packed handoff record -> decode continues
  without a second prefill
* ``GET  /requests``          one status snapshot of every handle
* ``GET  /handoff?request_id=`` the packed record (pops the outbox)
* ``GET  /health``            the serving health block and identity
* ``GET  /introspect``        KV-pool accounting, the parameter digest,
  the kernel launch counts, the handoff counters and IPC buffers held
* ``POST /drain`` / ``POST /shutdown``  graceful exits (code 0)
* ``POST /ipc/hold`` / ``/ipc/release`` / ``/ipc/discard``  the device-to-
  device route's confirmations (a port-only addition, below)

On a CUDA host with ``use_pallas_kernels`` set, a prefill job's export
gathers its record straight into an IPC-exported device buffer (:class:`~paddle_tpu_torch.
inference.kv_handoff.IPCOutbox`) and the packed record carries the
buffer's descriptor instead of the page bytes; a decode host pulls the
pages with the remote-copy kernel and confirms the pull through these
endpoints. Elsewhere the packed record carries the bytes.

Chaos flags cross the process boundary as ``FLAGS_*`` environment
variables the child's flag registry reads at import; numerics settings
such as ``CUBLAS_WORKSPACE_CONFIG`` are read from the environment by
cuBLAS itself. TF32 is off in every host.

Model construction is deterministic: the spec names a builder, a seed and
a device, and the weights are drawn from a generator with that seed on that
device, so every process building one spec holds the same bits (the host
logs :func:`~paddle_tpu_torch.weights.param_digest` at start and reports
it in ``/introspect``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict
from urllib.parse import parse_qs, urlparse

__all__ = ["build_from_spec", "main", "EXIT_LOOP_DEAD"]

EXIT_LOOP_DEAD = 86


def build_from_spec(spec: Dict[str, Any]):
    """Deterministically build (model, engine, server) from a host spec::

        {"model": "llama_tiny" | "hybrid_ssm", "seed": 7,
         "device": "cuda" | "cpu",            # default "cuda"
         "config": {...config overrides...},
         "engine": {...GenerationEngine kwargs...},
         "server": {...GenerationServer kwargs...}}
    """
    from paddle_tpu_torch.inference.engine import GenerationEngine
    from paddle_tpu_torch.inference.server import GenerationServer

    kind = spec.get("model", "llama_tiny")
    overrides = dict(spec.get("config") or {})
    device = spec.get("device", "cuda")
    seed = int(spec.get("seed", 0))
    if kind == "llama_tiny":
        from paddle_tpu_torch.models import (LlamaForCausalLM,
                                             llama_tiny_config)
        model = LlamaForCausalLM(llama_tiny_config(**overrides),
                                 device=device, seed=seed)
    elif kind == "hybrid_ssm":
        from paddle_tpu_torch.models import (HybridSSMForCausalLM,
                                             ssm_tiny_config)
        model = HybridSSMForCausalLM(ssm_tiny_config(**overrides),
                                     device=device, seed=seed)
    else:
        raise ValueError(f"unknown model spec {kind!r}")
    model.eval()
    engine = GenerationEngine(model, **dict(spec.get("engine") or {}))
    server = GenerationServer(engine, **dict(spec.get("server") or {}))
    return model, engine, server


def _request_from_payload(payload: Dict[str, Any]):
    from paddle_tpu_torch.inference.engine import GenerationRequest
    return GenerationRequest(
        payload["request_id"], list(payload["prompt"]),
        max_new_tokens=int(payload.get("max_new_tokens", 32)),
        temperature=payload.get("temperature", 0.0),
        top_k=payload.get("top_k", 0),
        top_p=payload.get("top_p", 1.0),
        eos_token_id=payload.get("eos_token_id"),
        seed=payload.get("seed"))


def _submit_kwargs(payload: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    if payload.get("timeout_s") is not None:
        out["timeout_s"] = float(payload["timeout_s"])
    if payload.get("deadline_s") is not None:
        out["deadline_s"] = float(payload["deadline_s"])
    return out


class _HostState:
    """Everything the HTTP handlers share with the serving loop."""

    def __init__(self, host, server, digest: str = ""):
        self.host = host                  # in-process ServingHost
        self.server = server
        self.digest = digest
        self.lock = threading.Lock()
        self.outbox: Dict[str, bytes] = {}       # rid -> packed record
        self.prefill_settled: set = set()        # sink saw record=None
        self.drain = threading.Event()
        self.shutdown = threading.Event()
        self.ipc = None                   # IPCOutbox on the device route
        self.wire = {"packs": 0, "pack_s": 0.0, "unpacks": 0,
                     "unpack_s": 0.0}

    def prefill_sink(self, request_id, record, handle) -> None:
        """Runs on the serving-loop thread (which owns the engine): pack
        the exported record at once (on the device route its pages are
        already in the outbox's buffer), so that no HTTP thread touches
        engine state."""
        from paddle_tpu_torch.inference import kv_handoff
        rid = str(request_id)
        if record is None:
            with self.lock:
                self.prefill_settled.add(rid)
            return
        t0 = time.perf_counter()
        wire = kv_handoff.pack_handoff(record)
        with self.lock:
            self.wire["packs"] += 1
            self.wire["pack_s"] += time.perf_counter() - t0
            self.outbox[rid] = wire

    def requests_snapshot(self) -> Dict[str, Any]:
        handles = dict(self.server.handles)
        with self.lock:
            ready = set(self.outbox)
            settled = set(self.prefill_settled)
        out = {}
        for rid, h in handles.items():
            srid = str(rid)
            out[srid] = {
                "output_ids": list(h.output_ids),
                "done": bool(h.done),
                "finish_reason": h.finish_reason,
                "error": h.request.error,
                "handoff_ready": srid in ready,
                "prefill_settled": srid in settled,
            }
        return {"alive": self.host.alive, "requests": out}

    def introspect(self) -> Dict[str, Any]:
        from paddle_tpu_torch.inference import kv_handoff
        from paddle_tpu_torch.ops import kernels
        eng = self.server.engine
        with self.lock:
            wire = dict(self.wire)
        return {
            "free_blocks": eng.cache.free_blocks,
            "num_blocks": eng.cache.num_blocks,
            "num_active": eng.num_active,
            "queue_depth": len(self.server._queue),
            "handles": len(self.server.handles),
            "digest": self.digest,
            "pid": os.getpid(),
            "device": str(eng.cache.device),
            "launches": kernels.launch_counts(),
            "handoff": dict(kv_handoff.handoff_stats(eng), **wire),
            "ipc_held": 0 if self.ipc is None else self.ipc.held,
            "ipc": None if self.ipc is None else dict(self.ipc.counters),
        }


def _make_handler(state: _HostState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):        # silence per-request spam
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, code, body):
            self.send_response(code)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/health":
                snap = dict(state.host.health())
                snap["wall_ts"] = time.time()
                self._json(200, snap)
            elif url.path == "/requests":
                self._json(200, state.requests_snapshot())
            elif url.path == "/handoff":
                rid = (parse_qs(url.query).get("request_id") or [""])[0]
                with state.lock:
                    wire = state.outbox.pop(rid, None)
                if wire is None:
                    self._json(404, {"error": f"no handoff for {rid!r}"})
                else:
                    self._bytes(200, wire)
            elif url.path == "/introspect":
                self._json(200, state.introspect())
            else:
                self._json(404, {"error": "unknown path"})

        def _trace_ctx(self, payload, request_id):
            """Inbound trace context (the header or the JSON field); a
            missing one while tracing is armed mints a local trace."""
            from paddle_tpu_torch.observability import tracing
            if not tracing.enabled():
                return None
            ctx = tracing.from_header(
                self.headers.get(tracing.TRACE_HEADER)
                or payload.get("trace"))
            return ctx if ctx is not None else tracing.mint(request_id)

        def do_POST(self):
            url = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b""
            if url.path == "/submit_prefilled":
                from paddle_tpu_torch.inference.kv_handoff import \
                    unpack_handoff
                q = parse_qs(url.query)
                kwargs = {}
                if q.get("timeout_s"):
                    kwargs["timeout_s"] = float(q["timeout_s"][0])
                if q.get("deadline_s"):
                    kwargs["deadline_s"] = float(q["deadline_s"][0])
                t0 = time.perf_counter()
                try:
                    record = unpack_handoff(raw)
                except Exception as e:                # noqa: BLE001
                    self._json(400, {"error": f"bad record: {e}"})
                    return
                with state.lock:
                    state.wire["unpacks"] += 1
                    state.wire["unpack_s"] += time.perf_counter() - t0
                state.server.submit_prefilled(record, **kwargs)
                self._json(200, {"ok": True,
                                 "request_id": str(record["request_id"])})
                return
            try:
                payload = json.loads(raw or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": "bad json"})
                return
            if url.path == "/submit":
                req = _request_from_payload(payload)
                ctx = self._trace_ctx(payload, req.request_id)
                if ctx is not None:
                    req.trace = ctx
                h = state.server.submit(req, **_submit_kwargs(payload))
                prior = payload.get("prior")
                if prior:
                    h._prior = list(prior)
                self._json(200, {"ok": True})
            elif url.path == "/prefill":
                req = _request_from_payload(payload)
                ctx = self._trace_ctx(payload, req.request_id)
                if ctx is not None:
                    req.trace = ctx
                state.host.submit_prefill(
                    req, functools.partial(state.prefill_sink,
                                           req.request_id),
                    **_submit_kwargs(payload))
                self._json(200, {"ok": True})
            elif url.path in ("/ipc/hold", "/ipc/release", "/ipc/discard"):
                ipc = state.ipc
                gen = payload.get("generation")
                ok = ipc is not None and gen is not None and getattr(
                    ipc, url.path.rsplit("/", 1)[-1])(int(gen))
                self._json(200, {"ok": bool(ok)})
            elif url.path == "/drain":
                state.drain.set()
                self._json(200, {"ok": True})
            elif url.path == "/shutdown":
                state.shutdown.set()
                self._json(200, {"ok": True})
            else:
                self._json(404, {"error": "unknown path"})

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="serving-fleet subprocess host")
    p.add_argument("--name", required=True)
    p.add_argument("--role", default="unified",
                   choices=["prefill", "decode", "unified"])
    p.add_argument("--master", required=True,
                   help="launch master address (http://host:port)")
    p.add_argument("--spec", required=True,
                   help="host spec JSON (or @/path/to/spec.json)")
    p.add_argument("--poll-s", type=float, default=0.002)
    p.add_argument("--health-interval-s", type=float, default=0.05)
    args = p.parse_args(argv)

    spec_text = args.spec
    if spec_text.startswith("@"):
        with open(spec_text[1:], encoding="utf-8") as f:
            spec_text = f.read()
    spec = json.loads(spec_text)

    import torch

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.launch.master import MasterClient
    from paddle_tpu_torch.inference import kv_handoff
    from paddle_tpu_torch.inference.router import ServingHost
    from paddle_tpu_torch.weights import param_digest

    # no TF32: a host must compute what a one-process run on the same
    # weights computes, bit for bit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model, engine, server = build_from_spec(spec)
    digest = param_digest(model)
    print(f"serve_host {args.name}: {args.role}, model built on "
          f"{engine.cache.device} in {time.perf_counter() - t0:.1f} s, "
          f"parameter digest {digest}", flush=True)
    host = ServingHost(args.name, server, role=args.role,
                       master_address=args.master,
                       health_interval_s=args.health_interval_s)
    state = _HostState(host, server, digest)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))
    endpoint = f"http://127.0.0.1:{httpd.server_port}"
    if kv_handoff.dma_handoff_enabled(engine):
        state.ipc = kv_handoff.IPCOutbox(engine.cache.device, endpoint,
                                         args.name)
        engine._handoff_outbox = state.ipc     # exports gather into it
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name=f"serve-host-http-{args.name}").start()

    client = MasterClient(args.master, args.name, endpoint=endpoint)
    client.serve_register(args.role)
    host._thread = threading.current_thread()   # mark started

    # the supervisor owns this process: exit when the parent is gone
    parent_pid = os.getppid()

    code = EXIT_LOOP_DEAD
    try:
        while True:
            if os.getppid() != parent_pid:
                code = 0
                break
            if state.shutdown.is_set():
                code = 0
                break
            if state.drain.is_set():
                server.drain(finish_active=True)
                try:
                    client.leave()
                except Exception:                 # noqa: BLE001
                    pass
                code = 0
                break
            if not host.step():
                # the loop died (chaos kill or crash): exit nonzero with
                # no cleanup, as a SIGKILLed host looks
                code = EXIT_LOOP_DEAD
                break
            if not server._pending():
                time.sleep(args.poll_s)
    except BaseException:           # noqa: BLE001 — SimulatedCrash too
        traceback.print_exc()
        code = EXIT_LOOP_DEAD
    finally:
        obs.flush()
    return code


if __name__ == "__main__":
    sys.exit(main())
