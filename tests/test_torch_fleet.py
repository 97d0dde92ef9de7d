"""The port's serving plane against the JAX package's, on the CPU: the
request-level server, health-weighted admission, the threaded fleet and
the process-true fleet.

Weights are made by the JAX model (seeded) and carried across with
``load_jax_state`` where the two packages are compared; greedy streams are
compared token for token (fp32 tiny models: both packages pick the same
tokens). The port's fleets are held bit for bit against its own one-process
runs: a handoff or a failover must not change a greedy stream. The process
fleet spawns ``serve_host`` children on the CPU (``"device": "cpu"``),
which move pages over the serialized route.
"""

import dataclasses
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import FleetRouter as JaxRouter
from paddle_tpu.inference import GenerationEngine as JaxEngine
from paddle_tpu.inference import GenerationRequest as JaxRequest
from paddle_tpu.inference import GenerationServer as JaxServer
from paddle_tpu.inference import ServingHost as JaxHost
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_llama_tiny
from paddle_tpu_torch.distributed.launch import serve_host
from paddle_tpu_torch.distributed.launch.master import (HTTPMaster,
                                                        MasterClient)
from paddle_tpu_torch.inference import (ElasticityPolicy, FleetRouter,
                                        FleetSupervisor, GenerationEngine,
                                        GenerationRequest, GenerationServer,
                                        ServingHost)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.testing import fault_injection
from paddle_tpu_torch.weights import load_jax_state

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)
ENGINE = dict(max_seqs=4, max_seq_len=128, block_size=16)


@pytest.fixture(scope="module")
def pair():
    """A seeded tiny fp32 JAX Llama and the port's copy of it (CPU)."""
    paddle.seed(7)
    jcfg = jax_llama_tiny(**TINY)
    jm = JaxLlama(jcfg)
    jm.eval()
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    pm = LlamaForCausalLM(LlamaConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name in names}), device="cpu")
    load_jax_state(pm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, pm


def _engine(model, **kw):
    return GenerationEngine(model, **{**ENGINE, **kw})


def _req(rid, plen=5, max_new=4, cls=GenerationRequest, **kw):
    rng = np.random.RandomState(3 + sum(map(ord, str(rid))) % 97)
    return cls(rid, rng.randint(0, 128, size=plen).tolist(),
               max_new_tokens=max_new, **kw)


def _drill_clean(server):
    eng = server.engine
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert eng.num_active == 0
    assert not server._queue and not server._active


def _one_process(model, reqs):
    """Greedy streams of one unkilled server, each request alone."""
    srv = GenerationServer(_engine(model))
    out = {}
    for rid, plen, mx in reqs:
        h = srv.submit(_req(rid, plen, mx))
        assert srv.run_until_idle()
        out[rid] = list(h.output_ids)
    srv.close()
    return out


# ------------------------------------------------------------- the server
def test_server_streams_equal_jax(pair):
    """The same requests through each package's server (batched, one of
    them paused by a wedged consumer for a while): every stream token
    for token the same, and the port's pages all back."""
    jm, pm = pair
    reqs = [(f"s{i}", 5 + i, 6) for i in range(4)]
    out = {}
    for name, srv_cls, req_cls, model in (
            ("jax", JaxServer, JaxRequest, jm),
            ("port", GenerationServer, GenerationRequest, pm)):
        eng_cls = JaxEngine if name == "jax" else GenerationEngine
        srv = srv_cls(eng_cls(model, **ENGINE), stream_buffer=2)
        hs = {r: srv.submit(_req(r, n, m, cls=req_cls)) for r, n, m in reqs}
        for _ in range(200):
            srv.step()
            for r, h in hs.items():
                if r != "s1":                     # s1's consumer is slow
                    while h.next_token(timeout=0) is not None:
                        pass
            if all(h.done for r, h in hs.items() if r != "s1"):
                break
        assert hs["s1"].request.paused and not hs["s1"].done
        while not hs["s1"].done:
            while hs["s1"].next_token(timeout=0) is not None:
                pass
            srv.step()
        out[name] = {r: list(h.output_ids) for r, h in hs.items()}
        assert all(h.finish_reason == "length" for h in hs.values())
        srv.close()
    assert out["port"] == out["jax"]


def test_shed_on_queue_full_and_wait_budget(pair):
    pm = pair[1]
    srv = GenerationServer(_engine(pm), max_queue=2)
    hs = [srv.submit(_req(i)) for i in range(5)]
    shed = [h for h in hs if h.finish_reason == "shed"]
    assert len(shed) == 3 and all("queue full" in h.result()["error"]
                                  for h in shed)
    srv.run_until_idle()
    assert [h.finish_reason for h in hs[:2]] == ["length"] * 2
    assert srv.counters["shed"] == 3
    _drill_clean(srv)
    srv.close()
    srv = GenerationServer(_engine(pm), max_queue=16,
                           queue_wait_budget_s=0.01)
    h1 = srv.submit(_req(1))
    time.sleep(0.02)
    h2 = srv.submit(_req(2))
    assert h2.finish_reason == "shed" and "budget" in h2.result()["error"]
    srv.run_until_idle()
    assert h1.finish_reason == "length"
    _drill_clean(srv)
    srv.close()


def test_deadlines_evict_and_reclaim(pair):
    pm = pair[1]
    srv = GenerationServer(_engine(pm))
    h = srv.submit(_req(1, max_new=10_000), timeout_s=0.05)
    for _ in range(500):
        srv.step()
        if h.done:
            break
    assert h.finish_reason == "timeout" and h.output_ids
    hd = srv.submit(_req(2, max_new=10_000), deadline_s=time.time() + 0.05)
    srv.run_until_idle()
    assert hd.finish_reason == "deadline"
    assert srv.counters["timeout"] == 1 and srv.counters["deadline_miss"] == 1
    _drill_clean(srv)
    with fault_injection.inject(fault_serve_deadline="storm:0.03"):
        hs = [srv.submit(_req(i, max_new=10_000)) for i in range(6)]
        srv.run_until_idle()
    assert all(h.finish_reason == "timeout" for h in hs)
    _drill_clean(srv)
    h = srv.submit(_req(100))                # the storm is over
    srv.run_until_idle()
    assert h.finish_reason == "length"
    srv.close()


def test_client_stall_fault_pauses_one_request(pair):
    srv = GenerationServer(_engine(pair[1]), stream_buffer=1)
    with fault_injection.inject(fault_serve_client="stall:1"):
        victim, other = srv.submit(_req(1, max_new=6)), \
            srv.submit(_req(2, max_new=6))
        for _ in range(64):
            srv.step()
            while other.next_token(timeout=0) is not None:
                pass
            if other.done:
                break
        assert other.finish_reason == "length"
        assert not victim.done and victim.request.paused
    while not victim.done:
        while victim.next_token(timeout=0) is not None:
            pass
        srv.step()
    assert victim.finish_reason == "length" and len(victim.output_ids) == 6
    _drill_clean(srv)
    srv.close()


def test_drain_and_resubmit_lose_nothing(pair, tmp_path):
    """A drain requeue-serializes every admitted and queued request; a
    fresh server finishes each to its full budget, streams equal to an
    undrained run's."""
    pm = pair[1]
    want = _one_process(pm, [(i, 5, 12) for i in range(4)])
    srv = GenerationServer(_engine(pm, num_blocks=2, max_seqs=2),
                           drain_path=str(tmp_path / "drain.json"))
    hs = {i: srv.submit(_req(i, max_new=12)) for i in range(4)}
    for _ in range(3):
        srv.step()
    records = srv.drain(path=str(tmp_path / "drain.json"))
    assert {r["request_id"] for r in records} == set(range(4))
    assert any(r["generated"] for r in records)
    assert all(h.finish_reason == "drained" for h in hs.values())
    _drill_clean(srv)
    srv.close()
    assert srv.submit(_req(9)).finish_reason == "shed"    # still draining
    srv2 = GenerationServer(_engine(pm))
    restored = srv2.resubmit_drained(str(tmp_path))
    assert set(restored) == set(range(4))
    srv2.run_until_idle()
    for i, h in restored.items():
        assert h.finish_reason == "length" and h.output_ids == want[i]
    _drill_clean(srv2)
    srv2.close()


# -------------------------------------------------------------- admission
class _StubHost:
    def __init__(self, name, serving, role="decode"):
        self.name, self.role, self.alive = name, role, True
        self._serving = serving

    def health(self):
        return dict(self._serving)


HEALTH = [None, {"draining": True},
          {"queue_depth": 0, "occupancy": 0.0, "shed": 0, "step_age_s": 0.0},
          {"queue_depth": 9, "occupancy": 0.5, "shed": 2, "step_age_s": 0.0},
          {"queue_depth": 1, "occupancy": 1.0, "shed": 0, "step_age_s": 11.0},
          {"queue_depth": 3, "occupancy": 0.25, "shed": 20,
           "step_age_s": 0.5}]


def test_admission_weight_equals_jax():
    for h in HEALTH:
        assert FleetRouter.admission_weight(h) == \
            JaxRouter.admission_weight(h), h


@pytest.mark.parametrize("partition", [None, "h1"])
def test_swrr_picks_equal_jax(partition):
    """The same health blocks give the same deterministic SWRR sequence
    in both packages, with and without a partitioned host."""
    from paddle_tpu.testing import fault_injection as jax_faults
    seqs = []
    for router_cls, faults in ((JaxRouter, jax_faults),
                               (FleetRouter, fault_injection)):
        hosts = [_StubHost(f"h{i}", h) for i, h in enumerate(HEALTH[2:])]
        router = router_cls()
        for h in hosts:
            router.register_host(h)
        spec = {} if partition is None else \
            {"fault_router_partition": f"drop:{partition}"}
        with faults.inject(**spec):
            seqs.append([router._pick(hosts).name for _ in range(60)])
    assert seqs[0] == seqs[1]
    assert seqs[1].count("h0") > 5 * seqs[1].count("h1")    # idle wins


# --------------------------------------------------------- threaded fleet
def _threaded_fleet(router_cls, host_cls, server_cls, engine_cls, model):
    router = router_cls()
    hosts = {n: router.register_host(host_cls(
        n, server_cls(engine_cls(model, **ENGINE)), role=role))
        for n, role in (("pf0", "prefill"), ("dc0", "decode"),
                        ("dc1", "decode"))}
    return router, hosts


def test_threaded_fleet_equals_jax_and_one_process(pair):
    """One prefill and two decode hosts: every prompt prefills on pf0, its
    pages hand off, decode runs on a decode host; the streams equal the
    JAX fleet's token for token and the port's one-process run bit for
    bit, with both pools leak-free."""
    jm, pm = pair
    reqs = [(f"t{i}", 5 + i % 3, 8) for i in range(5)]
    out = {}
    for name, clses, model, req_cls in (
            ("jax", (JaxRouter, JaxHost, JaxServer, JaxEngine), jm,
             JaxRequest),
            ("port", (FleetRouter, ServingHost, GenerationServer,
                      GenerationEngine), pm, GenerationRequest)):
        router, hosts = _threaded_fleet(*clses, model)
        for h in hosts.values():
            h.start()
        handles = {r: router.submit(_req(r, n, m, cls=req_cls))
                   for r, n, m in reqs}
        assert router.run_until_idle(timeout_s=120.0), router.stats()
        out[name] = {r: list(h.output_ids) for r, h in handles.items()}
        assert router.counters["handoffs"] == len(reqs)
        assert hosts["pf0"].server.counters["completed"] == 0
        for h in hosts.values():
            h.stop()
            _drill_clean(h.server)
    assert out["port"] == out["jax"]
    assert out["port"] == _one_process(pm, reqs)


def test_threaded_fleet_decode_host_kill(pair):
    """``fault_serve_kill`` hard-kills dc1's loop mid-stream: every request
    finishes on the survivors, bit for bit the one-process run (whose
    streams are the JAX server's token for token), with no leak on the
    survivors."""
    jm, pm = pair
    reqs = [(f"k{i}", 5 + i % 3, 16) for i in range(6)]
    want = _one_process(pm, reqs)
    jsrv = JaxServer(JaxEngine(jm, **ENGINE))
    jh = {r: jsrv.submit(_req(r, n, m, cls=JaxRequest)) for r, n, m in reqs}
    assert jsrv.run_until_idle()
    assert {r: list(h.output_ids) for r, h in jh.items()} == want
    router, hosts = _threaded_fleet(FleetRouter, ServingHost,
                                    GenerationServer, GenerationEngine, pm)
    for h in hosts.values():
        h.start()
    handles = {r: router.submit(_req(r, n, m), timeout_s=60.0)
               for r, n, m in reqs}
    deadline = time.time() + 30
    while time.time() < deadline:
        with hosts["dc1"].server._lock:
            if any(h.request.output_ids and not h.request.finished
                   for h in hosts["dc1"].server._active.values()):
                break
        router.poll()
        time.sleep(0.001)
    with fault_injection.inject(fault_serve_kill="dc1:1"):
        while hosts["dc1"].alive and time.time() < deadline:
            time.sleep(0.001)
        assert not hosts["dc1"].alive, "the kill never fired"
        assert router.run_until_idle(timeout_s=120.0), router.stats()
    for r, h in handles.items():
        assert h.finish_reason == "length" and h.output_ids == want[r], r
    assert router.counters["failed_hosts"] == 1
    for n in ("pf0", "dc0"):
        hosts[n].stop()
        _drill_clean(hosts[n].server)


# ---------------------------------------------------------- process fleet
SPEC = {"model": "llama_tiny", "seed": 7, "device": "cpu",
        "config": TINY,
        "engine": {**ENGINE, "num_blocks": 64},
        "server": {"max_queue": 64}}


def _spec_baseline(reqs):
    """One-process greedy streams on the spec's own weights."""
    _, _, srv = serve_host.build_from_spec(SPEC)
    out = {}
    for rid, plen, mx in reqs:
        h = srv.submit(_req(rid, plen, mx))
        assert srv.run_until_idle()
        out[rid] = list(h.output_ids)
    srv.close()
    return out


def _leak_free(*hosts):
    for h in hosts:
        ins = h.introspect()
        assert ins["free_blocks"] == ins["num_blocks"], (h.name, ins)
        assert ins["num_active"] == 0, (h.name, ins)


def test_process_fleet_handoff_kill_recovery(tmp_path):
    """Port ``serve_host`` children on the CPU: (a) prefill→decode across
    processes over the serialized route, bit for bit the one-process run,
    leak-free; (b) a SIGKILL of a decode host mid-stream loses no token
    and the master's incident closes with a finite MTTR; (c) ``ensure``
    respawns it and the respawn serves; (d) chaos flags armed in the
    parent reach a child, whose loop dies on cue."""
    reqs_a = [(f"r{i}", 6 + i, 10) for i in range(3)]
    reqs_b = [(f"b{i}", 5 + i, 14) for i in range(4)]
    post = [("post0", 7, 6)]
    base = _spec_baseline(reqs_a + reqs_b + post)
    master = HTTPMaster(ttl=30.0, serve_ttl=2.0, ops_hang_after=60.0,
                        ops_bundle_grace=0.05, ops_poll=0.05)
    sup = FleetSupervisor(master.address, SPEC,
                          log_dir=str(tmp_path / "logs"))
    router = FleetRouter(master_address=master.address)
    try:
        for name, role in (("pf0", "prefill"), ("dc0", "decode"),
                           ("dc1", "decode")):
            sup.spawn(name, role, wait_ready=False)
        for name in ("pf0", "dc0", "dc1"):
            router.register_host(sup.wait_ready(name))
        digests = {n: h.introspect()["digest"] for n, h in sup.hosts.items()}
        assert len(set(digests.values())) == 1, digests
        fleet = MasterClient(master.address, "probe").serve_fleet()["hosts"]
        assert fleet["pf0"]["role"] == "prefill" and len(fleet) == 3

        # (a) the handoff across processes
        handles = {r: router.submit(_req(r, n, m)) for r, n, m in reqs_a}
        assert router.run_until_idle(timeout_s=120.0, poll_s=0.01)
        for r, h in handles.items():
            assert h.output_ids == base[r], r
            assert h.ttft_s is not None and h.e2e_s is not None
        assert router.counters["handoffs"] == len(reqs_a)
        ins = {n: h.introspect() for n, h in sup.hosts.items()}
        assert ins["pf0"]["handoff"]["packs"] == len(reqs_a)
        assert sum(ins[n]["handoff"]["unpacks"] for n in ("dc0", "dc1")) \
            == len(reqs_a)
        assert all(i["ipc"] is None and i["launches"][
            "kv_pages_remote_copy"] == 0 for i in ins.values())
        _leak_free(*sup.hosts.values())

        # (b) SIGKILL a decode host mid-stream
        handles = {r: router.submit(_req(r, n, m)) for r, n, m in reqs_b}
        deadline = time.monotonic() + 60.0
        mid = False
        while time.monotonic() < deadline and not mid:
            router.poll()
            with router._lock:
                mid = any(e.state == "decode" and e.host == "dc1"
                          and e.tokens for e in router.journal.values()
                          if e.request_id.startswith("b"))
            time.sleep(0.002)
        assert mid, "never caught dc1 mid-stream"
        sup.kill("dc1")
        assert router.run_until_idle(timeout_s=120.0, poll_s=0.01)
        for r, h in handles.items():
            assert h.finish_reason == "length" and h.output_ids == base[r], r
        assert router.counters["failovers"] >= 1
        _leak_free(sup.hosts["pf0"], sup.hosts["dc0"])
        mttr, deadline = None, time.time() + 15
        while mttr is None and time.time() < deadline:
            done = MasterClient(master.address, "probe").incidents()
            mttr = done["incidents"][-1]["mttr_seconds"] \
                if done["incidents"] else None
            time.sleep(0.05)
        assert mttr is not None and 0 < mttr < 60

        # (c) recovery: the respawn serves
        assert sup.ensure(router=router) == ["dc1"]
        assert len(sup.live_hosts("decode")) == 2
        assert sup.hosts["dc1"].introspect()["digest"] == digests["pf0"]
        h = router.submit(_req(*post[0][:2], post[0][2]))
        assert router.run_until_idle(timeout_s=60.0, poll_s=0.01)
        assert h.output_ids == base["post0"]

        # (d) a chaos flag armed here reaches a child through its env
        with fault_injection.inject(fault_serve_kill="dc9:3"):
            dead = sup.spawn("dc9", "decode", wait_ready=False)
        router.register_host(dead)
        deadline = time.monotonic() + 30.0
        while sup.procs["dc9"].poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.procs["dc9"].returncode == serve_host.EXIT_LOOP_DEAD
        router.poll()
        assert not dead.alive and router.counters["failed_hosts"] == 2
    finally:
        router.close()
        sup.close()
        master.shutdown()


def test_serve_ttl_sweeps_a_silent_serving_host():
    master = HTTPMaster(ttl=30.0, serve_ttl=0.3)
    try:
        trainer = MasterClient(master.address, "trainer0",
                               endpoint="http://127.0.0.1:1")
        trainer.register()
        corpse = MasterClient(master.address, "dc-corpse",
                              endpoint="http://127.0.0.1:2")
        corpse.serve_register("decode")
        assert "dc-corpse" in corpse.serve_fleet()["hosts"]
        time.sleep(0.6)
        assert "dc-corpse" not in corpse.serve_fleet()["hosts"]
        assert "trainer0" in trainer.status()["peers"]
    finally:
        master.shutdown()


def test_environment_snapshot_carries_armed_flags_only():
    assert fault_injection.env_snapshot() == {}
    with fault_injection.inject(fault_serve_kill="dc0:2",
                                fault_router_partition="drop:x"):
        snap = fault_injection.env_snapshot()
    assert snap == {"FLAGS_fault_injection": "1",
                    "FLAGS_fault_serve_kill": "dc0:2",
                    "FLAGS_fault_router_partition": "drop:x"}
    assert fault_injection.env_snapshot() == {}


# ------------------------------------------------------ what stays unported
def test_unported_fleet_pieces_refuse(tmp_path):
    """The autoscaler, armed tracing, the metrics streams and the training
    ops plane raise, each naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="A.11"):
        ElasticityPolicy()
    with pytest.raises(NotImplementedError, match="A.12"):
        tracing.configure(enabled=True)
    assert tracing.mint("r") is None and not tracing.enabled()
    with pytest.raises(NotImplementedError, match="A.12"):
        FleetSupervisor("http://127.0.0.1:1", SPEC, obs_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="A.12"):
        HTTPMaster(state_path=str(tmp_path / "state.json"))
    master = HTTPMaster()
    try:
        sup = FleetSupervisor(master.address, SPEC)
        with pytest.raises(NotImplementedError, match="A.11"):
            sup.autoscale_step(None)
        client = MasterClient(master.address, "n0")
        with pytest.raises(NotImplementedError, match="A.12"):
            client.upload_bundle({"reason": "hang"})
        req = urllib.request.Request(
            master.address + "/bundle", data=b'{"name": "n0"}',
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 404
    finally:
        master.shutdown()


def test_host_spec_builds_on_the_requested_device():
    model, engine, server = serve_host.build_from_spec(SPEC)
    assert model.device == torch.device("cpu")
    assert engine.cache.device == torch.device("cpu")
    assert engine.max_seqs == ENGINE["max_seqs"]
    server.close()


def test_param_digest_sees_every_position():
    """The hosts' parameter digest tells apart models whose tensors hold
    the same values at other positions: two elements trading places, next
    to each other or one digest slab (2**24 elements) apart, change it."""
    from paddle_tpu_torch.weights import _DIGEST_SLAB, param_digest
    g = torch.Generator().manual_seed(0)
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.randn(_DIGEST_SLAB + 8, generator=g)
                             .to(torch.bfloat16), requires_grad=False)
    m.b = torch.nn.Parameter(torch.randn(3, 5, generator=g))
    d0 = param_digest(m)
    assert param_digest(m) == d0
    w = m.w.data
    for i, j in ((1, 2), (3, 3 + _DIGEST_SLAB)):
        assert w[i] != w[j]
        w[i], w[j] = w[j].clone(), w[i].clone()
        assert param_digest(m) != d0, (i, j)
        w[i], w[j] = w[j].clone(), w[i].clone()
        assert param_digest(m) == d0
