"""The port's refcounted prefix cache with copy-on-write and its
prompt-lookup speculative decode against the JAX package's, on the CPU
(``tests/test_spec_prefix.py`` and the quantized prefix/COW drill of
``tests/test_kv_quant.py``).

The allocator drills run one script of cache operations on a JAX
``PagedKVCache`` and on the port's, and compare after every operation the
return value, the free list, every slot's table and refcounts, the free,
available and indexed block counts and the evictions, exactly; pages and
scales written or copied are compared bit for bit. The engines run tiny
fp32 Llamas whose weights the JAX model made (seeded) and
``load_jax_state`` carried across; greedy streams and the engines' spec and
prefix counters are compared exactly with the JAX engine's. Seeded sampled
streams are held against the port's own engine without the option (the
port's sampler draws its own noise from ``(seed, counter)``, so its sampled
tokens are not the JAX sampler's).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JaxEngine
from paddle_tpu.inference import GenerationRequest as JaxRequest
from paddle_tpu.inference.paged_cache import PagedKVCache as JaxCache
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu_torch import flags
from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)


def _port_of(jm):
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    pm = LlamaForCausalLM(LlamaConfig(**{
        f.name: getattr(jm.config, f.name)
        for f in dataclasses.fields(jm.config) if f.name in names}),
        device="cpu")
    load_jax_state(pm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return pm


@pytest.fixture(scope="module")
def pair():
    """The reference tests' tiny model (seed 7) and the port's copy."""
    paddle.seed(7)
    jm = JaxLlama(jax_tiny_config(**TINY))
    jm.eval()
    return jm, _port_of(jm)


def _prompts(n, vocab, lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n_).tolist() for n_ in lens[:n]]


# ------------------------------------------------------ allocator drills
def _is_jax(c):
    return not isinstance(c.k, torch.Tensor)


class Drill:
    """Runs one script on a cache and logs what the script observes."""

    def __init__(self, c):
        self.c = c
        self.log = []

    def check(self, value=None):
        c = self.c
        self.log.append(("state", value, c.free_blocks, c.available_blocks,
                         c.prefix_blocks, c.prefix_evictions, list(c._free),
                         [list(t) for t in c._tables],
                         [c.block_refs(s) for s in range(c.max_seqs)]))
        return value

    def write(self, slot, n, seed=0, scale=1.0):
        """Seeded rows ``[n, kv, d]`` written at the slot's first n
        positions of layer 0 (a quantized pool quantizes them)."""
        c = self.c
        rs = np.random.RandomState(seed)
        shape = (n,) + tuple(c.k.shape[2:])
        k = (rs.randn(*shape) * scale).astype(np.float32)
        v = (rs.randn(*shape) * scale).astype(np.float32)
        rows = c.slot_mapping(slot, 0, n)
        if _is_jax(c):
            c.write(0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows))
        else:
            c.write(0, torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(rows.astype(np.int64)))

    def pages(self, slot, n):
        """Log the raw bytes of the slot's first n rows (pages and, on a
        quantized pool, scales)."""
        c = self.c
        rows = np.asarray(c.slot_mapping(slot, 0, n), np.int64)
        planes = [c.k, c.v] + ([] if c.quant is None
                               else [c.k_scale, c.v_scale])
        out = []
        for p in planes:
            if _is_jax(c):
                a = np.asarray(p[0, rows])
            else:
                t = p[0, torch.from_numpy(rows)]
                a = (t.view(torch.uint8) if t.element_size() == 1
                     else t).numpy()
            out.append(a.tobytes())
        self.log.append(("pages", out))
        return out


def _run(script, **cache_kw):
    """The script on the JAX cache and on the port's; their logs equal."""
    kw = dict(num_blocks=8, block_size=4, max_seqs=4)
    kw.update(cache_kw)
    logs = []
    for cls in (JaxCache, PagedKVCache):
        c = cls(1, kw["num_blocks"], kw["block_size"], kw.get("kv", 1),
                kw.get("d", 4), kw["max_seqs"], quant=kw.get("quant"))
        d = Drill(c)
        script(d, c)
        logs.append(d.log)
    jax_log, port_log = logs
    assert len(jax_log) == len(port_log)
    for i, (a, b) in enumerate(zip(jax_log, port_log)):
        assert a == b, (i, a, b)
    return port_log


def register_adopt_round_trip(d, c):
    toks = list(range(8))
    s = d.check(c.allocate_slot())
    assert d.check(c.ensure_capacity(s, 8))
    assert d.check(c.register_prefix(s, toks, 8)) == 2
    assert c.block_refs(s) == [2, 2]
    assert d.check(c.register_prefix(s, toks, 8)) == 0    # idempotent
    c.free_slot(s)
    d.check()
    assert c.free_blocks == 6              # the index still holds 2
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, toks + [9])) == 8
    assert c.block_refs(s2) == [2, 2]
    assert d.check(c.ensure_capacity(s2, 9))              # private tail
    assert c.block_refs(s2) == [2, 2, 1]
    c.free_slot(s2)
    assert d.check(c.clear_prefix()) == 2
    assert c.free_blocks == c.num_blocks


def adopt_full_cover_copies_last_block(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    c.ensure_capacity(s, 8)
    d.write(s, 8, seed=1)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    d.check()
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, toks)) == 8
    assert c.block_refs(s2) == [2, 1]       # shared, then a private copy
    d.pages(s2, 8)                          # the copy holds the same rows
    c.free_slot(s2)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def cow_divergence(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    c.ensure_capacity(s, 8)
    d.write(s, 4, seed=2)
    c.register_prefix(s, toks, 8)
    before = d.pages(s, 4)
    shared = c._tables[s][0]
    assert d.check(c.cow_block(s, 0))
    assert c._tables[s][0] != shared and c.block_refs(s)[0] == 1
    assert d.pages(s, 4) == before
    assert d.check(c.cow_block(s, 0))       # private now: a no-op
    c.free_slot(s)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def eviction_never_frees_referenced_blocks(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    c.ensure_capacity(s, 8)
    c.register_prefix(s, toks, 8)
    s2 = c.allocate_slot()
    assert d.check(c.ensure_capacity(s2, 8))
    assert not d.check(c.ensure_capacity(s2, 12))
    assert c.block_refs(s) == [2, 2]
    c.free_slot(s)
    assert d.check(c.ensure_capacity(s2, 12))   # the LRU entry goes
    assert c.prefix_evictions >= 1
    c.free_slot(s2)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def full_cover_cow_never_reuses_run_block(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    run = list(c._prefix.values())
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, toks)) == 4
    assert list(c._tables[s2]) == run[:1]
    c.free_slot(s2)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def full_cover_cow_evicts_only_non_run_victim(d, c):
    tok_a, tok_b = list(range(8)), [90, 91, 92, 93]
    sa = c.allocate_slot()
    assert c.ensure_capacity(sa, 8)
    c.register_prefix(sa, tok_a, 8)
    c.free_slot(sa)
    sb = c.allocate_slot()
    assert c.ensure_capacity(sb, 4)
    c.register_prefix(sb, tok_b, 4)
    c.free_slot(sb)
    decoy = c._prefix[c._chain_hashes(tok_b, 4)[0]]
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, tok_a)) == 8
    assert c._tables[s2][1] == decoy and c.prefix_evictions == 1
    c.free_slot(s2)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def trim_keeps_shared_blocks(d, c):
    toks = list(range(8))
    s = c.allocate_slot()
    c.ensure_capacity(s, 8)
    c.register_prefix(s, toks, 8)
    c.free_slot(s)
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, toks + [9])) == 8
    assert d.check(c.ensure_capacity(s2, 12))
    c.trim_slot(s2, 4)                      # wants 1 block; shared stay
    assert d.check(len(c._tables[s2])) == 2
    c.trim_slot(s2, 0)
    assert d.check(len(c._tables[s2])) == 2
    c.free_slot(s2)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def free_slot_keeps_indexed_blocks(d, c):
    """The repaired ``free_slot``: a slot's blocks that the index also
    holds stay allocated when the slot goes, and a second slot linked onto
    them keeps them through the first one's exit."""
    toks = list(range(12))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 12)
    d.write(s, 12, seed=3)
    c.register_prefix(s, toks, 12)
    held = list(c._tables[s])
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, toks + [1])) == 12
    c.free_slot(s)
    d.check()
    assert not set(held) & set(c._free)
    assert c.block_refs(s2) == [2, 2, 2]
    d.pages(s2, 12)
    c.free_slot(s2)
    d.check()
    assert not set(held) & set(c._free)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def cow_copies_scales(d, c):
    """``test_kv_quant.py``'s COW drill: the private copy carries its
    scale rows bit for bit."""
    toks = list(range(8))
    s = c.allocate_slot()
    c.ensure_capacity(s, 8)
    d.write(s, 4, seed=4, scale=3.0)
    c.register_prefix(s, toks, 8)
    before = d.pages(s, 4)
    assert d.check(c.cow_block(s, 0))
    assert d.pages(s, 4) == before
    c.free_slot(s)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks


def quant_prefix_cow_eviction(d, c):
    """``test_kv_quant.py``'s available-blocks drill: a quantized pool
    under sharing, COW and pressure eviction keeps exact accounting."""
    toks = list(range(8))
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 8)
    c.register_prefix(s, toks, 8)
    assert d.check(c.available_blocks) == 4
    s2 = c.allocate_slot()
    assert d.check(c.adopt_prefix(s2, toks + [9])) == 8
    assert d.check(c.ensure_capacity(s2, 9))
    assert d.check(c.cow_block(s2, 0))
    c.free_slot(s)
    assert d.check(c.available_blocks) == c.free_blocks + 1
    s3 = c.allocate_slot()
    assert d.check(c.ensure_capacity(s3, 8))
    c.free_slot(s2)
    c.free_slot(s3)
    d.check(c.clear_prefix())
    assert c.free_blocks == c.num_blocks == c.available_blocks


@pytest.mark.parametrize("script,kw", [
    (register_adopt_round_trip, {}),
    (adopt_full_cover_copies_last_block, {}),
    (cow_divergence, {}),
    (eviction_never_frees_referenced_blocks, dict(num_blocks=4)),
    (full_cover_cow_never_reuses_run_block, dict(num_blocks=2)),
    (full_cover_cow_evicts_only_non_run_victim, dict(num_blocks=3)),
    (trim_keeps_shared_blocks, {}),
    (free_slot_keeps_indexed_blocks, {}),
    (cow_copies_scales, dict(quant="int8", kv=2, d=8)),
    (cow_copies_scales, dict(quant="fp8", kv=2, d=8)),
    (quant_prefix_cow_eviction, dict(quant="int8", num_blocks=6, kv=2,
                                     d=8)),
], ids=lambda v: getattr(v, "__name__", None))
def test_allocator_drill_matches_jax(script, kw):
    _run(script, **kw)


def test_prefix_peeks_and_chain_hashes_match_jax():
    """The chained hashes are the reference's bytes, and the peeks read
    them without touching counts or LRU order."""
    jc, pc = JaxCache(1, 8, 4, 1, 4, 4), PagedKVCache(1, 8, 4, 1, 4, 4)
    toks = list(range(13))
    assert jc._chain_hashes(toks, 13) == pc._chain_hashes(toks, 13)
    for c in (jc, pc):
        s = c.allocate_slot()
        c.ensure_capacity(s, 12)
        c.register_prefix(s, toks, 12)
    for probe in (toks, toks[:8], toks[:4] + [0] * 8, [5] * 9):
        assert pc.peek_prefix(probe) == jc.peek_prefix(probe)
        assert pc.peek_prefix_resident(probe) == jc.peek_prefix_resident(
            probe)
    assert list(pc._prefix) == list(jc._prefix)
    assert pc.block_refs(0) == jc.block_refs(0) == [2, 2, 2]


def test_copy_block_is_one_copy_per_plane(monkeypatch):
    """``_copy_block`` moves a page with one ``index_copy_`` over every
    layer for each plane (pages, and scales on a quantized pool)."""
    calls = []
    real = torch.Tensor.index_copy_

    def spy(self, dim, index, source):
        calls.append((tuple(self.shape), dim, int(index.numel())))
        return real(self, dim, index, source)
    for quant, planes in ((None, 2), ("int8", 4)):
        c = PagedKVCache(3, 4, 4, 2, 8, 2, quant=quant)
        calls.clear()
        monkeypatch.setattr(torch.Tensor, "index_copy_", spy)
        assert c._copy_block(0) is not None
        monkeypatch.undo()
        assert len(calls) == planes
        assert all(dim == 1 and n == 4 and shape[0] == 3
                   for shape, dim, n in calls)


# ------------------------------------------------------- engine helpers
def _jax_engine(jm, **kw):
    kw.setdefault("mode", "compiled")
    return JaxEngine(jm, **kw)


def _port_engine(pm, **kw):
    kw.setdefault("mode", "compiled")
    return GenerationEngine(pm, **kw)


STAT_KEYS = ("decode_tokens", "prefill_tokens", "decode_rows",
             "spec_drafted", "spec_accepted", "spec_rollbacks",
             "prefix_lookup_tokens", "prefix_hit_tokens")


def _stats(eng):
    return {k: eng.stats[k] for k in STAT_KEYS}


def _both(pair, calls, **kw):
    """Run ``calls`` — a list of ``[(rid, prompt, new_tokens), ...]`` waves,
    one ``generate`` each — through one JAX engine and one port engine of
    the same options; after each wave the streams, the engines' counters
    and the caches' free lists and counts are equal. Returns the port
    engine."""
    jm, pm = pair
    je, pe = _jax_engine(jm, **kw), _port_engine(pm, **kw)
    for wave in calls:
        jo = je.generate([JaxRequest(r, p, max_new_tokens=m)
                          for r, p, m in wave])
        po = pe.generate([GenerationRequest(r, p, max_new_tokens=m)
                          for r, p, m in wave])
        assert po == jo
        assert _stats(pe) == _stats(je)
        for attr in ("free_blocks", "available_blocks", "prefix_blocks",
                     "prefix_evictions"):
            assert getattr(pe.cache, attr) == getattr(je.cache, attr), attr
        assert list(pe.cache._free) == list(je.cache._free)
    return pe, je


# ------------------------------------------------------ speculative decode
SPEC_ENGINE = dict(max_seqs=4, max_seq_len=128, block_size=16)


def test_spec_greedy_matches_jax_and_nonspec(pair):
    """Four drafts a row: the greedy streams and every spec counter equal
    the JAX engine's, the streams equal decode without drafts, drafts were
    accepted, and every page is back after the drain."""
    prompts = _prompts(3, 128, (9, 17, 5), seed=11)
    wave = [(i, p, 24) for i, p in enumerate(prompts)]
    pe, _ = _both(pair, [wave], spec_tokens=4, **SPEC_ENGINE)
    assert pe.stats["spec_drafted"] > 0 and pe.stats["spec_accepted"] > 0
    assert pe.cache.free_blocks == pe.cache.num_blocks
    base = _port_engine(pair[1], spec_tokens=0, **SPEC_ENGINE)
    assert base.generate([GenerationRequest(r, p, max_new_tokens=m)
                          for r, p, m in wave]) == pe.generate(
        [GenerationRequest(r, p, max_new_tokens=m) for r, p, m in wave])


def test_spec_sampled_matches_nonspec(pair):
    """Seeded sampling: each output column samples with its own counter,
    so the sampled streams equal those without drafts, with greedy and
    sampled rows in one draft-verify step."""
    _, pm = pair
    prompts = _prompts(3, 128, (9, 17, 5), seed=12)

    def reqs():
        return [GenerationRequest(i, p, max_new_tokens=24,
                                  temperature=0.8 if i < 2 else 0.0,
                                  top_k=20, top_p=0.95, seed=100 + i)
                for i, p in enumerate(prompts)]
    ref = _port_engine(pm, spec_tokens=0, token_bucket_floor=8,
                       **SPEC_ENGINE).generate(reqs())
    eng = _port_engine(pm, spec_tokens=3, token_bucket_floor=8,
                       **SPEC_ENGINE)
    assert eng.generate(reqs()) == ref
    assert eng.stats["spec_drafted"] > 0


def test_spec_rollback_reclaims_pages(pair):
    """A rejected draft rewinds the cursor and returns whole over-reserved
    pages: the pool drains clean and the streams equal decode without
    drafts (the rollback counts are held against the JAX engine's in
    ``test_spec_greedy_matches_jax_and_nonspec``)."""
    _, pm = pair
    prompts = _prompts(4, 128, (6, 9, 12, 17), seed=5)

    def run(k):
        eng = _port_engine(pm, spec_tokens=k, token_bucket_floor=4,
                           **SPEC_ENGINE)
        return eng, eng.generate([GenerationRequest(i, p, max_new_tokens=20)
                                  for i, p in enumerate(prompts)])
    pe, out = run(4)
    st = pe.stats
    assert st["spec_drafted"] > 0 and st["spec_rollbacks"] > 0
    assert pe.cache.free_blocks == pe.cache.num_blocks
    assert out == run(0)[1]


def test_spec_bench_floor():
    """``bench_serve_llama_spec``'s CPU configuration (4 layers, hidden
    256, 8:4 heads, vocab 256; 8 prompts of 12 tokens, 96 new tokens,
    blocks of 32): with four drafts the streams equal decode without them,
    at least 2 tokens are emitted per decode row (the reference's CPU
    floor), and rollback leaks no page."""
    from paddle_tpu_torch.models import llama_tiny_config
    cfg = llama_tiny_config(num_hidden_layers=4, hidden_size=256,
                            intermediate_size=512, num_attention_heads=8,
                            num_key_value_heads=4, vocab_size=256,
                            max_position_embeddings=512)
    model = LlamaForCausalLM(cfg, seed=0, device="cpu").eval()
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, 12).tolist() for _ in range(8)]
    res = {}
    for k in (0, 4):
        eng = _port_engine(model, max_seqs=8, max_seq_len=12 + 96 + 32,
                           block_size=32, spec_tokens=k)
        out = eng.generate([GenerationRequest(i, p, max_new_tokens=96)
                            for i, p in enumerate(prompts)])
        res[k] = (out, eng.stats["decode_tokens"]
                  / max(1, eng.stats["decode_rows"]))
        assert eng.cache.free_blocks == eng.cache.num_blocks
    assert res[4][0] == res[0][0]
    assert res[4][1] >= 2.0, res[4][1]


def test_spec_defaults_and_step_budget(pair):
    _, pm = pair
    eng = _port_engine(pm, **SPEC_ENGINE)
    assert eng.spec_tokens == 0 and not eng._prefix_on
    assert eng.max_tokens_per_step == 4 + 64
    eng = _port_engine(pm, spec_tokens=3, prefill_chunk=16, **SPEC_ENGINE)
    assert eng.max_tokens_per_step == 4 * (1 + 3) + 16


def test_propose_drafts_matches_jax(pair):
    """Prompt lookup over a cycling context: the 3-gram, then 2-gram, match
    and the periodic extension give the reference's drafts at every
    step of an incrementally growing context."""
    jm, pm = pair
    je = _jax_engine(jm, spec_tokens=4, **SPEC_ENGINE)
    pe = _port_engine(pm, spec_tokens=4, **SPEC_ENGINE)
    ctx = [1, 2, 3, 4, 1, 2, 3, 9, 9, 9, 1, 2]
    jr, pr = JaxRequest(0, ctx[:3]), GenerationRequest(0, ctx[:3])
    for t in ctx[3:] + [3, 4, 1, 2, 3]:
        for k in (1, 4):
            assert pe._propose_drafts(pr, k) == je._propose_drafts(jr, k)
        jr.output_ids.append(t)
        pr.output_ids.append(t)


def test_moe_spec_decode_compiled():
    """An MoE stack with drafts in the compiled step: the greedy stream
    equals the port's eager walk and the JAX compiled engine's."""
    paddle.seed(13)
    jm = JaxLlama(jax_tiny_config(num_hidden_layers=1, hidden_size=32,
                                  intermediate_size=64,
                                  num_attention_heads=4,
                                  num_key_value_heads=4, vocab_size=64,
                                  moe_num_experts=2,
                                  moe_capacity_factor=8.0))
    jm.eval()
    pm = _port_of(jm)
    prompt = [1, 2, 3, 4, 5]
    kw = dict(max_seqs=2, max_seq_len=64, block_size=16)
    ref = GenerationEngine(pm, mode="eager", **kw).generate(
        [GenerationRequest(0, prompt, max_new_tokens=6)])
    eng = GenerationEngine(pm, mode="auto", spec_tokens=2, **kw)
    assert eng.mode == "compiled"
    assert eng.generate([GenerationRequest(0, prompt,
                                           max_new_tokens=6)]) == ref
    assert eng.cache.free_blocks == eng.cache.num_blocks
    jout = JaxEngine(jm, mode="auto", spec_tokens=2, **kw).generate(
        [JaxRequest(0, prompt, max_new_tokens=6)])
    assert jout == ref


# ---------------------------------------------------------- prefix serving
PREFIX_ENGINE = dict(max_seqs=2, max_seq_len=128, block_size=16,
                     prefix_cache=True)


def test_prefix_serving_matches_jax(pair):
    """One engine of each package through the reference's prefix-serving
    cases in turn: a repeated 40-token prompt links two blocks and
    re-prefills 8 tokens, an aligned fully cached 32-token prompt
    re-prefills one token over a private copy of its last block, and a
    prompt sharing only its first block links just that block. Streams,
    counters and pool state equal the JAX engine's after each wave, and
    the streams equal a cold engine's."""
    a = _prompts(1, 128, (40,), seed=21)[0]
    b = _prompts(1, 128, (32,), seed=22)[0]
    c = a[:16] + _prompts(1, 128, (8,), seed=24)[0]
    waves = [[(0, a, 8)], [(1, a, 8)], [(2, b, 6)], [(3, b, 6)],
             [(4, c, 6)]]
    pe, je = _both(pair, waves, **PREFIX_ENGINE)
    assert pe.stats["prefix_hit_tokens"] >= 32 + 31 + 16
    cold = _port_engine(pair[1], max_seqs=2, max_seq_len=128, block_size=16)
    for i, (p, m) in enumerate(((a, 8), (b, 6), (c, 6))):
        want = cold.generate([GenerationRequest(i, p, max_new_tokens=m)])[i]
        got = pe.generate([GenerationRequest(10 + i, p,
                                             max_new_tokens=m)])[10 + i]
        assert got == want
    assert pe.num_active == 0
    pe.release_prefix_cache()
    assert pe.cache.free_blocks == pe.cache.num_blocks


def test_prefix_prefill_counts(pair):
    """Only the tail past the linked run re-prefills: 8 tokens for the
    repeated 40-token prompt (two blocks linked), 1 for the aligned
    32-token prompt, 8 for the prompt that shares one block."""
    _, pm = pair
    eng = _port_engine(pm, **PREFIX_ENGINE)
    a = _prompts(1, 128, (40,), seed=21)[0]
    b = _prompts(1, 128, (32,), seed=22)[0]
    c = a[:16] + _prompts(1, 128, (8,), seed=24)[0]
    for rid, p, want in ((0, a, 40), (1, a, 8), (2, b, 32), (3, b, 1),
                         (4, c, 8)):
        pre = eng.stats["prefill_tokens"]
        eng.generate([GenerationRequest(rid, p, max_new_tokens=4)])
        assert eng.stats["prefill_tokens"] - pre == want, rid
    eng.release_prefix_cache()
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_prefix_pressure_evicts_cold_entries(pair):
    """Five distinct prompts overflow a 6-block pool: cold entries are
    evicted LRU-first exactly as in the JAX engine, nothing leaks."""
    waves = [[(i, _prompts(1, 128, (40,), seed=30 + i)[0], 4)]
             for i in range(5)]
    pe, _ = _both(pair, waves, **dict(PREFIX_ENGINE, max_seq_len=64,
                                      num_blocks=6))
    assert pe.cache.prefix_evictions > 0
    pe.release_prefix_cache()
    assert pe.cache.free_blocks == pe.cache.num_blocks


def test_stale_peek_queues_instead_of_admitting(pair):
    """The estimate's peek takes no reference: entries evicted between it
    and admission make ``add_request`` refuse (queue) and roll back."""
    _, pm = pair
    eng = _port_engine(pm, **dict(PREFIX_ENGINE, max_seq_len=64,
                                  num_blocks=6))
    warm = _prompts(1, 128, (48,), seed=40)[0]
    eng.generate([GenerationRequest(0, warm, max_new_tokens=4)])
    req2 = GenerationRequest(1, warm, max_new_tokens=16)
    assert eng.estimated_blocks(req2) == 2
    d = eng.cache.allocate_slot()
    assert eng.cache.ensure_capacity(d, 48)
    eng.release_prefix_cache()
    assert eng.cache.free_blocks >= 2
    assert not eng.add_request(req2)
    assert eng.num_active == 0 and eng.cache.free_blocks == 3
    eng.cache.free_slot(d)
    out = eng.generate([req2], return_details=True)
    assert out[1]["finish_reason"] == "length"
    eng.release_prefix_cache()
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_spec_and_prefix_compose(pair):
    """Both on: the linked request's drafted greedy stream equals the JAX
    engine's with both on and a plain engine's."""
    prompt = _prompts(1, 128, (40,), seed=25)[0]
    pe, _ = _both(pair, [[(0, prompt, 12)], [(1, prompt, 12)]],
                  spec_tokens=3, **PREFIX_ENGINE)
    base = _port_engine(pair[1], max_seqs=2, max_seq_len=128, block_size=16)
    ref = base.generate([GenerationRequest(0, prompt, max_new_tokens=12)])
    again = pe.generate([GenerationRequest(2, prompt, max_new_tokens=12)])
    assert again[2] == ref[0]
    pe.release_prefix_cache()
    assert pe.cache.free_blocks == pe.cache.num_blocks


def test_quantized_prefix_serving(pair):
    """int8 pages under the prefix cache: a linked request reads the seed
    request's quantized pages and scales; its stream and the engines'
    counters equal the JAX int8 engine's, and the stream a cold int8
    engine decodes."""
    _, pm = pair
    prompt = _prompts(1, 128, (40,), seed=26)[0]
    cold = _port_engine(pm, kv_quant="int8", max_seqs=2, max_seq_len=128,
                        block_size=16).generate(
        [GenerationRequest(0, prompt, max_new_tokens=8)])
    eng, _ = _both(pair, [[(0, prompt, 8)], [(1, prompt, 8)]],
                   kv_quant="int8", **PREFIX_ENGINE)
    out = eng.generate([GenerationRequest(2, prompt, max_new_tokens=8)])
    assert out[2] == cold[0] and eng.stats["prefix_hit_tokens"] == 64
    eng.release_prefix_cache()
    assert eng.cache.free_blocks == eng.cache.num_blocks


@pytest.fixture
def reset_flags():
    saved = {n: flags.flag(n) for n in ("serve_spec_tokens",
                                        "serve_prefix_cache")}
    yield
    flags.set_flags(saved)


def test_flags_turn_the_options_on(pair, reset_flags):
    _, pm = pair
    flags.set_flags({"serve_spec_tokens": 3, "serve_prefix_cache": True})
    eng = _port_engine(pm, **SPEC_ENGINE)
    assert eng.spec_tokens == 3 and eng._prefix_on
