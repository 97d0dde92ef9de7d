"""The port's host-RAM KV tier against the JAX package's, on the CPU
(``tests/test_kv_tiers.py``).

The allocator drills run one script on a JAX ``PagedKVCache`` with a host
tier and on the port's, and compare after every operation the return
value, both tiers' block accounting, the spill, restore and eviction
counts and every slot's table and refcounts, exactly; pages (full width and
int8/fp8 with their scales) that spill and come back are compared bit for
bit with what was written. The engines run a tiny fp32 Llama whose weights
the JAX model made (seeded, carried across by ``load_jax_state``): greedy
streams and tier counters are compared exactly with the JAX engine's, and a
parked and restored request's stream with the port's own untiered run. The
reference bench's CPU floor (the tiered prefix hit rate at least twice the
device-only one) is asserted here.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import GenerationEngine as JaxEngine
from paddle_tpu.inference import GenerationRequest as JaxRequest
from paddle_tpu.inference import GenerationServer as JaxServer
from paddle_tpu.inference.kv_tiers import HostKVTier as JaxTier
from paddle_tpu.inference.kv_tiers import HostPage as JaxPage
from paddle_tpu.inference.paged_cache import PagedKVCache as JaxCache
from paddle_tpu_torch.inference import (FleetRouter, GenerationEngine,
                                        GenerationRequest, GenerationServer,
                                        ServingHost, kv_handoff)
from paddle_tpu_torch.inference.kv_tiers import HostKVTier, HostPage
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.testing import fault_injection
from test_torch_spec_prefix import Drill, pair  # noqa: F401 (fixture)

TIER_KEYS = ("prefix_spills", "prefix_restores", "slot_spills",
             "slot_restores", "spilled_prefix_blocks", "parked_slots",
             "resident_prefix_blocks", "host_num_blocks", "host_used_blocks",
             "host_free_blocks", "host_available_blocks", "spills",
             "restores", "spill_bytes", "restore_bytes", "host_evictions")


class TierDrill(Drill):
    def check(self, value=None):
        super().check(value)
        st = self.c.tier_stats()
        self.log.append(("tier", [st.get(k) for k in TIER_KEYS]))
        return value


def _new(cls, num_blocks=8, block_size=4, max_seqs=4, host_bytes=None,
         quant=None, kv=1, d=4):
    return cls(1, num_blocks, block_size, kv, d, max_seqs, quant=quant,
               host_tier_bytes=host_bytes)


def _run(script, **kw):
    logs = []
    for cls in (JaxCache, PagedKVCache):
        c = _new(cls, **kw)
        d = TierDrill(c)
        script(d, c)
        logs.append(d.log)
    assert len(logs[0]) == len(logs[1])
    for i, (a, b) in enumerate(zip(*logs)):
        assert a == b, (i, a, b)


def _tiers_empty(c):
    assert c.free_blocks == c.num_blocks == c.available_blocks, \
        (c.free_blocks, c.num_blocks, c.available_blocks)
    if c.host_tier is not None:
        ht = c.host_tier
        assert ht.free_blocks == ht.num_blocks == ht.available_blocks


ONE_BLOCK = 1 * 4 * 1 * 4 * 4 * 2      # layers x rows x kv x d x fp32 x K,V


# ------------------------------------------------------ allocator drills
def spill_preferred_over_eviction(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    d.write(s, 8, seed=0)
    want = d.pages(s, 8)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    s2 = c.allocate_slot()
    assert d.check(c.ensure_capacity(s2, 16))    # spills both entries
    assert c.prefix_spills == 2 and c.prefix_evictions == 0
    assert d.check(c.peek_prefix(toks)) == 8
    assert d.check(c.peek_prefix_resident(toks)) == 0
    c.free_slot(s2)
    s3 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s3, toks + [9])) == 8   # restored
    assert c.block_refs(s3)[:2] == [2, 2]
    assert d.pages(s3, 8) == want
    c.free_slot(s3)
    d.check(c.clear_prefix())
    _tiers_empty(c)


def unpinned_lru_rotation(d, c):
    assert c.host_tier.num_blocks == 1
    toks = list(range(8))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    s2 = c.allocate_slot()
    assert d.check(c.ensure_capacity(s2, 16))
    assert c.prefix_spills == 2 and c.host_tier.host_evictions == 1
    assert c.prefix_evictions == 1 and c.spilled_prefix_blocks == 1
    c.free_slot(s2)
    d.check(c.clear_prefix())
    _tiers_empty(c)


def pinned_tier_refuses_prefix_spills(d, c):
    toks = list(range(8))
    sa = c.allocate_slot()
    assert c.ensure_capacity(sa, 4)
    d.write(sa, 4, seed=5)
    want = d.pages(sa, 4)
    assert d.check(c.spill_slot(sa)) == 1        # a pinned page fills it
    assert c.host_tier.available_blocks == 0
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    s2 = c.allocate_slot()
    assert d.check(c.ensure_capacity(s2, 24))    # evicts, cannot spill
    assert c.prefix_spills == 0 and c.prefix_evictions == 2
    assert c.host_tier.host_evictions == 0
    c.free_slot(s2)
    assert d.check(c.restore_slot(sa))
    assert d.pages(sa, 4) == want
    c.free_slot(sa)
    d.check(c.clear_prefix())
    _tiers_empty(c)


def spill_then_cow_refcounts(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    d.write(s, 8, seed=2)
    want = d.pages(s, 4)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    s2 = c.allocate_slot()
    assert d.check(c.ensure_capacity(s2, 24))    # spills the index
    assert c.spilled_prefix_blocks == 2
    c.free_slot(s2)
    sa = c.allocate_slot()
    assert d.check(c.adopt_prefix(sa, toks + [9])) == 8
    sb = c.allocate_slot()
    assert d.check(c.adopt_prefix(sb, toks + [10])) == 8
    assert c.block_refs(sa) == [3, 3] == c.block_refs(sb)
    assert d.check(c.cow_block(sb, 0))
    assert c.block_refs(sb)[0] == 1 and c.block_refs(sa)[0] == 2
    assert d.pages(sb, 4) == want
    c.free_slot(sa)
    c.free_slot(sb)
    d.check(c.clear_prefix())
    _tiers_empty(c)


def quantized_round_trip(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    d.write(s, 8, seed=3, scale=3.0)
    want = d.pages(s, 8)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    s2 = c.allocate_slot()
    assert d.check(c.ensure_capacity(s2, 16))
    assert c.spilled_prefix_blocks == 2
    page = c.host_tier.get(next(iter(c._spilled)))
    assert page.k_scale is not None and page.v_scale is not None
    c.free_slot(s2)
    s3 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s3, toks + [3])) == 8
    assert d.pages(s3, 8) == want
    c.free_slot(s3)
    d.check(c.clear_prefix())
    _tiers_empty(c)


def park_staged_restore_and_free(d, c):
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    d.write(s, 8, seed=4)
    want = d.pages(s, 8)
    assert d.check(c.spillable_suffix(s)) == 2
    assert d.check(c.spill_slot(s)) == 2
    assert c._tables[s] == [] and c.free_blocks == 4
    assert d.check(c.slot_spilled(s)) == 2
    assert d.check(c.spill_slot(s)) == 0          # already parked
    assert d.check(c.restore_slot(s, staged=c.stage_restore(s)))
    assert d.pages(s, 8) == want
    c.free_slot(s)
    d.check()
    _tiers_empty(c)
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    assert d.check(c.spill_slot(s)) == 2
    c.free_slot(s)                                # pinned pages go too
    d.check()
    _tiers_empty(c)


def trim_a_parked_run(d, c):
    """A speculative rollback on a parked slot trims its parked tail."""
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 12)
    assert d.check(c.spill_slot(s)) == 3
    c.trim_slot(s, 5)
    assert d.check(c.slot_spilled(s)) == 2
    c.trim_slot(s, 0)
    assert d.check(c.slot_spilled(s)) == 0
    c.free_slot(s)
    d.check()
    _tiers_empty(c)


def shared_head_stays_when_parking(d, c):
    """Parking moves only the private tail; the shared head stays, and the
    restore reattaches the tail behind it."""
    toks = list(range(8))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    c.register_prefix(s, toks, 8)
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, toks + [1, 2, 3, 4, 5]))
    assert d.check(c.ensure_capacity(s2, 16))
    d.write(s2, 16, seed=6)
    want = d.pages(s2, 16)
    assert d.check(c.spillable_suffix(s2)) == 2
    assert d.check(c.spill_slot(s2)) == 2
    assert len(c._tables[s2]) == 2
    assert d.check(c.restore_slot(s2))
    assert d.pages(s2, 16) == want
    c.free_slot(s)
    c.free_slot(s2)
    d.check(c.clear_prefix())
    _tiers_empty(c)


@pytest.mark.parametrize("script,kw", [
    (spill_preferred_over_eviction, dict(num_blocks=4)),
    (unpinned_lru_rotation, dict(num_blocks=4, host_bytes=ONE_BLOCK)),
    (pinned_tier_refuses_prefix_spills, dict(num_blocks=6,
                                             host_bytes=ONE_BLOCK)),
    (spill_then_cow_refcounts, dict(num_blocks=6)),
    (quantized_round_trip, dict(num_blocks=4, quant="int8", kv=2, d=8)),
    (quantized_round_trip, dict(num_blocks=4, quant="fp8", kv=2, d=8)),
    (park_staged_restore_and_free, dict(num_blocks=4)),
    (trim_a_parked_run, dict(num_blocks=4)),
    (shared_head_stays_when_parking, dict(num_blocks=8)),
], ids=lambda v: getattr(v, "__name__", None))
def test_tier_drill_matches_jax(script, kw):
    kw.setdefault("host_bytes", 1 << 20)
    _run(script, **kw)


def test_one_block_budget_is_the_reference_size():
    assert _new(PagedKVCache).bytes_per_block == ONE_BLOCK
    assert _new(JaxCache).bytes_per_block == ONE_BLOCK


def test_host_tier_accounting_matches_jax():
    """The pool's bookkeeping, step by step: pinned pages never available,
    a put refused on a pinned-full pool, LRU eviction of unpinned pages."""
    seen = []
    for tier_cls, page_cls, zeros in (
            (JaxTier, JaxPage, lambda: np.zeros((1, 2, 1, 4), np.float32)),
            (HostKVTier, HostPage, lambda: torch.zeros(1, 2, 1, 4))):
        tier = tier_cls(2)
        pg = page_cls(zeros(), zeros(), None, None)
        log = [tier.put("a", pg, pinned=True), tier.put("b", pg, pinned=True),
               tier.available_blocks, tier.put("c", pg),
               tier.pop("a") is not None, tier.put("c", pg),
               tier.put("d", pg), tier.host_evictions, pg.nbytes]
        tier.pop("b")
        tier.pop("d")
        log.append(tier.stats())
        log.append(tier_cls.from_bytes(0, 1024).num_blocks)
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[1][6] == ["c"] and seen[1][3] is None


def test_cpu_pages_move_through_one_gather_and_one_scatter(monkeypatch):
    """A batch of pages leaves with one gather per plane and comes back
    with one ``index_copy_`` per plane, every layer at once."""
    c = PagedKVCache(3, 6, 4, 2, 8, 2, quant="int8", host_tier_bytes=1 << 20)
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 12)
    sel, cp = [], []
    real_sel, real_cp = torch.Tensor.index_select, torch.Tensor.index_copy_
    monkeypatch.setattr(torch.Tensor, "index_select",
                        lambda t, dim, i: sel.append(dim) or
                        real_sel(t, dim, i))
    monkeypatch.setattr(torch.Tensor, "index_copy_",
                        lambda t, dim, i, src: cp.append(dim) or
                        real_cp(t, dim, i, src))
    assert c.spill_slot(s) == 3
    assert c.restore_slot(s)
    assert sel == [1] * 4 and cp == [1] * 4


# ------------------------------------------------------------- engines
ENGINE = dict(max_seqs=4, max_seq_len=128, block_size=8, num_blocks=32,
              mode="compiled")


def _req(cls, rid, plen=9, max_new=10):
    rng = np.random.RandomState(3 + sum(map(ord, str(rid))) % 97)
    return cls(rid, rng.randint(0, 128, size=plen).tolist(),
               max_new_tokens=max_new)


def _pause_wave(engine_cls, req_cls, model, tier, restore_ahead=True):
    """Three requests; r0 pauses mid-decode, is parked (tiered arms) while
    the others decode, then resumes. Returns the streams and tier counts."""
    eng = engine_cls(model, host_tier=tier, host_tier_bytes=1 << 26,
                     restore_ahead=restore_ahead, **ENGINE)
    for i in range(3):
        assert eng.add_request(_req(req_cls, f"r{i}", plen=9 + i))
    outs = {}

    def reap():
        for r in eng.reap_finished():
            outs[r.request_id] = list(r.output_ids)
    for _ in range(4):
        eng.step()
    victim = eng._requests["r0"]
    assert victim.output_ids and not victim.finished
    victim.paused = True
    parked = eng.spill_paused() if tier else 0
    if tier:
        assert parked > 0 and eng.cache.slot_spilled(victim.slot) > 0
    frozen = len(victim.output_ids)
    for _ in range(5):
        eng.step()
    reap()
    assert len(victim.output_ids) == frozen
    victim.paused = False
    for _ in range(300):
        eng.step()
        reap()
        if not eng._requests:
            break
    assert sorted(outs) == ["r0", "r1", "r2"]
    assert all(len(v) == 10 for v in outs.values())
    _tiers_empty(eng.cache)
    st = eng.cache.tier_stats()
    return outs, parked, {k: st.get(k) for k in TIER_KEYS}


def test_restore_ahead_and_blocking_equal_untiered_and_jax(pair):
    """A parked and restored request's greedy continuation is the same
    whether the restore was staged a step ahead, done inline, or never
    needed; the staged arm's streams and tier counts equal the JAX
    engine's."""
    jm, pm = pair
    base, _, _ = _pause_wave(GenerationEngine, GenerationRequest, pm, False)
    ahead, p1, s1 = _pause_wave(GenerationEngine, GenerationRequest, pm,
                                True, restore_ahead=True)
    block, p2, s2 = _pause_wave(GenerationEngine, GenerationRequest, pm,
                                True, restore_ahead=False)
    assert p1 > 0 and p2 > 0
    assert s1["slot_restores"] == p1 and s2["slot_restores"] == p2
    assert ahead == base and block == base
    jout, jp, js = _pause_wave(JaxEngine, JaxRequest, jm, True,
                               restore_ahead=True)
    assert (ahead, p1, s1) == (jout, jp, js)


def _until_first_token(eng, rid):
    for _ in range(64):
        eng.step()
        if eng._requests[rid].output_ids:
            return


def test_handoff_export_from_parked_slot(pair):
    """Exporting a parked request assembles the record from the host
    tier's pages: bit for bit a never-parked export, with the refcounts and
    tokens the JAX engine's parked export carries; the slot stays parked,
    and the record installed elsewhere decodes on as one engine does."""
    jm, pm = pair
    prompt = _req(GenerationRequest, "h0").input_ids
    ref_eng = GenerationEngine(pm, **ENGINE)
    assert ref_eng.add_request(GenerationRequest("h0", list(prompt),
                                                 max_new_tokens=2))
    _until_first_token(ref_eng, "h0")
    ref = ref_eng.export_request("h0")

    recs = {}
    for name, eng_cls, req_cls, model in (
            ("jax", JaxEngine, JaxRequest, jm),
            ("port", GenerationEngine, GenerationRequest, pm)):
        a = eng_cls(model, host_tier=True, host_tier_bytes=1 << 26,
                    **ENGINE)
        assert a.add_request(req_cls("h0", list(prompt), max_new_tokens=2))
        _until_first_token(a, "h0")
        victim = a._requests["h0"]
        victim.paused = True
        assert a.spill_paused() > 0
        slot = victim.slot
        recs[name] = a.export_request("h0")
        assert a.cache.slot_spilled(slot) > 0      # no restore happened
        a.evict("h0", "handoff")
        a.reap_finished()
        _tiers_empty(a.cache)
    rec = recs["port"]
    for key in ("k", "v"):
        assert torch.equal(rec[key], ref[key])
    for key in ("block_refs", "generated", "seq_len", "prompt"):
        assert rec[key] == recs["jax"][key] == ref[key], key

    full = GenerationEngine(pm, **ENGINE)
    want = full.generate([GenerationRequest("h0", list(prompt),
                                            max_new_tokens=8)])["h0"]
    back = dict(kv_handoff.unpack_handoff(kv_handoff.pack_handoff(rec)))
    back["max_new_tokens"] = 8
    b = GenerationEngine(pm, **ENGINE)
    req = b.import_request(back)
    assert req is not None
    for _ in range(64):
        b.step()
        if b._requests.get("h0") is None:
            break
    assert list(req.output_ids) == want
    assert b.cache.free_blocks == b.cache.num_blocks


def test_host_death_with_parked_pages_replays_clean(pair):
    """The threaded fleet: a client-stalled request on dc0 is paused and
    parked (its pages only in dc0's host RAM) when dc0 dies; the replay
    finishes every stream bit for bit on a tiered survivor, which ends with
    both tiers empty."""
    _, pm = pair
    reqs = [_req(GenerationRequest, f"s{i}", plen=8 + i % 3, max_new=12)
            for i in range(4)]
    srv = GenerationServer(GenerationEngine(pm, **ENGINE))
    hs = {r.request_id: srv.submit(GenerationRequest(
        r.request_id, list(r.input_ids), max_new_tokens=12)) for r in reqs}
    assert srv.run_until_idle()
    base = {rid: list(h.output_ids) for rid, h in hs.items()}
    srv.close()

    def tiered():
        return GenerationServer(GenerationEngine(
            pm, host_tier=True, host_tier_bytes=1 << 26, **ENGINE))
    router = FleetRouter()
    dc0 = router.register_host(ServingHost("dc0", tiered(), role="decode"))
    handles = {r.request_id: router.submit(GenerationRequest(
        r.request_id, list(r.input_ids), max_new_tokens=12)) for r in reqs}
    with fault_injection.inject(fault_serve_client="stall:s0"):
        for _ in range(8):
            dc0.step()
            router.poll()
        eng = dc0.server.engine
        victim = eng._requests.get("s0")
        assert victim is not None and victim.paused
        assert eng.spill_paused() > 0
        assert eng.cache.slot_spilled(victim.slot) > 0
        for _ in range(3):
            dc0.step()
            router.poll()
        assert eng.cache.tier_stats()["parked_slots"] == 1
        with fault_injection.inject(fault_serve_kill="dc0:1"):
            assert not dc0.step()
    assert not dc0.alive
    dc1 = router.register_host(ServingHost("dc1", tiered(),
                                           role="decode").start())
    router.on_host_down("dc0")
    assert router.run_until_idle(timeout_s=120.0), router.stats()
    for rid, h in handles.items():
        assert h.finish_reason in ("eos", "length"), (rid, h.finish_reason)
        assert h.output_ids == base[rid], rid
    assert router.counters["failovers"] >= 1
    assert dc1.server.engine.num_active == 0
    _tiers_empty(dc1.server.engine.cache)
    dc1.stop()


def _family_wave(engine_cls, req_cls, server_cls, model, tiered):
    """``bench_serve_llama_prefix_tiered``'s CPU configuration: 16 requests
    alternating between two 32-token prefix families (4-token tails, 6 new
    tokens) over an 8-block pool of 8-token blocks, two slots."""
    rs = np.random.RandomState(0)
    families = [rs.randint(0, 128, 32).tolist() for _ in range(2)]
    tails = [rs.randint(0, 128, 4).tolist() for _ in range(16)]
    eng = engine_cls(model, max_seqs=2, max_seq_len=32 + 4 + 6 + 8,
                     block_size=8, num_blocks=8, mode="compiled",
                     prefix_cache=True, host_tier=tiered,
                     host_tier_bytes=1 << 26)
    srv = server_cls(eng, max_queue=18)
    for f in range(2):
        srv.submit(req_cls(("seed", f), families[f] + [1, 2, 3],
                           max_new_tokens=4))
        srv.run_until_idle()
    h0 = eng.stats["prefix_hit_tokens"]
    l0 = eng.stats["prefix_lookup_tokens"]
    outs = []
    for i in range(16):
        h = srv.submit(req_cls(("w", i), families[i % 2] + tails[i],
                               max_new_tokens=6))
        srv.run_until_idle()
        assert h.finish_reason in ("eos", "length"), h.finish_reason
        outs.append(list(h.output_ids))
    rate = ((eng.stats["prefix_hit_tokens"] - h0)
            / max(1, eng.stats["prefix_lookup_tokens"] - l0))
    st = eng.cache.tier_stats()
    srv.drain()
    eng.release_prefix_cache()
    _tiers_empty(eng.cache)
    srv.close()
    return rate, outs, {k: st.get(k) for k in TIER_KEYS}


def test_tiered_prefix_families_hold_their_hit_rate(pair):
    """The tiered arm's streams equal the device-only arm's, its pages
    spill and come back, its hit rate is at least twice the device-only
    one (the reference bench's CPU floor), and its hit rate and tier
    counts equal the JAX engine's."""
    jm, pm = pair
    base_rate, base_outs, _ = _family_wave(GenerationEngine,
                                           GenerationRequest,
                                           GenerationServer, pm, False)
    rate, outs, st = _family_wave(GenerationEngine, GenerationRequest,
                                  GenerationServer, pm, True)
    assert outs == base_outs
    assert st["prefix_spills"] > 0 and st["prefix_restores"] > 0
    assert rate >= 2.0 * base_rate
    jrate, jouts, jst = _family_wave(JaxEngine, JaxRequest, JaxServer, jm,
                                     True)
    assert (rate, outs, st) == (jrate, jouts, jst)


def test_prefix_bench_floor():
    """``bench_serve_llama_prefix``'s CPU configuration (4 layers, hidden
    256, 8:4 heads, vocab 1024, 8 slots, blocks of 32): a seed request,
    then 16 requests sharing a 160-token prefix with 16-token tails and 8
    new tokens through the server, cold and with the prefix cache. The
    streams are equal, the cache hits, the mean TTFT falls (the reference's
    CPU floor: a speedup above 1), and drain plus release leak nothing."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    cfg = llama_tiny_config(num_hidden_layers=4, hidden_size=256,
                            intermediate_size=512, num_attention_heads=8,
                            num_key_value_heads=4, vocab_size=1024,
                            max_position_embeddings=512)
    model = LlamaForCausalLM(cfg, seed=0, device="cpu").eval()
    rs = np.random.RandomState(0)
    shared = rs.randint(0, 1024, 160).tolist()
    tails = [rs.randint(0, 1024, 16).tolist() for _ in range(16)]

    def wave(prefix_on):
        eng = GenerationEngine(model, max_seqs=8,
                               max_seq_len=160 + 16 + 8 + 32, block_size=32,
                               mode="compiled", prefix_cache=prefix_on)
        srv = GenerationServer(eng, max_queue=16)
        srv.submit(GenerationRequest(("seed", 0), shared + [1, 2, 3],
                                     max_new_tokens=4))
        srv.run_until_idle()
        hs = [srv.submit(GenerationRequest(("w", i), shared + tails[i],
                                           max_new_tokens=8))
              for i in range(16)]
        srv.run_until_idle()
        assert all(h.finish_reason == "length" for h in hs)
        ttft = sum((h.first_token_ts - h.submit_ts) for h in hs) / 16
        outs = [list(h.output_ids) for h in hs]
        srv.drain()
        eng.release_prefix_cache()
        _tiers_empty(eng.cache)
        srv.close()
        return ttft, outs, eng.stats["prefix_hit_tokens"]
    cold, warm = wave(False), wave(True)
    assert warm[1] == cold[1]
    assert warm[2] > 0 and cold[2] == 0
    assert cold[0] / warm[0] > 1.0, (cold[0], warm[0])


def test_eager_mode_turns_the_tier_off(pair, monkeypatch):
    from paddle_tpu_torch.inference import engine as pt_engine
    _, pm = pair
    monkeypatch.setattr(pt_engine, "_warned_fallbacks", set())
    with pytest.warns(RuntimeWarning, match="kv host tier"):
        eng = GenerationEngine(pm, max_seqs=2, max_seq_len=64, block_size=8,
                               mode="eager", host_tier=True)
    assert eng.cache.host_tier is None and eng.spillable_blocks() == 0
    assert eng.spill_paused() == 0


def test_tier_flags_are_taken(pair):
    from paddle_tpu_torch import flags
    _, pm = pair
    names = ("serve_kv_host_tier", "serve_kv_host_bytes",
             "serve_kv_restore_ahead")
    saved = {n: flags.flag(n) for n in names}
    flags.set_flags({"serve_kv_host_tier": True,
                     "serve_kv_host_bytes": 3 * 4096 + 5,
                     "serve_kv_restore_ahead": False})
    try:
        eng = GenerationEngine(pm, max_seqs=2, max_seq_len=64, block_size=8,
                               mode="compiled")
    finally:
        flags.set_flags(saved)
    # 2 layers x 8 rows x 2 kv heads x 16 x fp32, K and V
    assert eng.cache.bytes_per_block == 4096
    assert eng.cache.host_tier.num_blocks == 3
    assert eng._restore_ahead is False
