"""The port's KV handoff against the JAX package's, on the CPU.

Weights are made by the JAX model (seeded) and carried across with
``load_jax_state``; prompts are made with numpy. A record exported by each
package after the same prompt agrees at fp32 rtol 1e-5 / atol 1e-6
(``tests/op_harness.py``) in its pages and equals in its header; the wire
format is one format: a record packed by either package unpacks in the
other with its arrays bit for bit, and repacking gives the same bytes. The
handoff's decode equals a one-engine run bit for bit, and #18's twin moves
the source's pages to the destination between two spawned gloo ranks.
"""

import dataclasses
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu.inference import GenerationEngine as JaxEngine
from paddle_tpu.inference import GenerationRequest as JaxRequest
from paddle_tpu.inference import kv_handoff as jax_kvh
from paddle_tpu.models import HybridSSMForCausalLM as JaxHybrid
from paddle_tpu.models import ssm_tiny_config as jax_ssm_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_llama_tiny
from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
from paddle_tpu_torch.inference import kv_handoff as pt_kvh
from paddle_tpu_torch.models import (HybridSSMForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, SSMConfig)
from paddle_tpu_torch.ops.kernels import kv_handoff as pt_k18
from paddle_tpu_torch.weights import load_jax_state, to_torch

FP32 = dict(rtol=1e-5, atol=1e-6)
ENGINE = dict(max_seqs=4, max_seq_len=128, block_size=16)
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)


def _np_state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


def _port_config(jcfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg) if f.name in names})


@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(7)
    jcfg = jax_llama_tiny(**TINY)
    jm = JaxLlama(jcfg)
    jm.eval()
    pm = LlamaForCausalLM(_port_config(jcfg, LlamaConfig), device="cpu")
    load_jax_state(pm, _np_state(jm))
    return jm, pm


@pytest.fixture(scope="module")
def hybrid_pair():
    old = jax_flags.flag("pallas_selective_scan")
    jax_flags.set_flags({"pallas_selective_scan": "on"})
    paddle.seed(0)
    jcfg = jax_ssm_tiny(dtype="float32", num_hidden_layers=4,
                        layer_pattern="SSA")
    jm = JaxHybrid(jcfg)
    jm.eval()
    pm = HybridSSMForCausalLM(_port_config(jcfg, SSMConfig), device="cpu")
    load_jax_state(pm, _np_state(jm))
    yield jm, pm
    jax_flags.set_flags({"pallas_selective_scan": old})


def _prompt(n, seed=3, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, size=n).tolist()


def _first_token(eng, rid, cap=64):
    """Step until the request's first token (a hybrid samples it at
    admission)."""
    for _ in range(cap):
        req = eng._requests.get(rid)
        if req is None or req.output_ids:
            return
        eng.step()
    raise AssertionError("no first token")


def _exports(pair, prompt, **kw):
    """The same request through each package up to its first token, then
    exported; both engines are returned with the request evicted."""
    jm, pm = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        je = JaxEngine(jm, **{**ENGINE, **kw})
        pe = GenerationEngine(pm, **{**ENGINE, **kw})
    assert je.add_request(JaxRequest("r", list(prompt), max_new_tokens=2))
    assert pe.add_request(GenerationRequest("r", list(prompt),
                                            max_new_tokens=2))
    _first_token(je, "r")
    _first_token(pe, "r")
    jrec, prec = je.export_request("r"), pe.export_request("r")
    for eng in (je, pe):
        eng.evict("r", "handoff")
        eng.reap_finished()
        assert eng.cache.free_blocks == eng.cache.num_blocks
    return jrec, prec


def _np(t):
    """A port array as numpy with the JAX package's dtype (bf16 and fp8
    through ml_dtypes), bit for bit."""
    t = torch.as_tensor(t).contiguous()
    name = str(t.dtype).rsplit(".", 1)[-1]
    if name in ("bfloat16", "float8_e4m3fn"):
        return t.view(torch.uint8 if t.element_size() == 1
                      else torch.int16).numpy().view(getattr(ml_dtypes,
                                                             name))
    return t.numpy()


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).tobytes(), str(a.dtype), a.shape


HEADER = ("request_id", "prompt", "generated", "max_new_tokens", "seq_len",
          "block_refs", "kv_quant", "temperature", "top_k", "top_p",
          "eos_token_id")


# ----------------------------------------------------------------- export
@pytest.mark.parametrize("kw", [{}, dict(kv_quant="int8")])
def test_export_matches_jax(llama_pair, kw):
    """One prompt through both packages: the header fields equal, the pages
    (and an int8 record's scales) within fp32 tolerance of each other."""
    jrec, prec = _exports(llama_pair, _prompt(21), **kw)
    for key in HEADER:
        assert prec[key] == jrec[key], key
    assert prec["version"] == jrec["version"] == 3
    keys = ["k", "v"] + (["k_scale", "v_scale"] if kw else [])
    for key in keys:
        got = _np(prec[key]).astype(np.float64)
        want = np.asarray(jrec[key]).astype(np.float64)
        assert got.shape == want.shape, key
        if kw and key in ("k", "v"):
            # one int8 step of rounding where the fp32 rows differ by ulps
            assert np.abs(got - want).max() <= 1.0, key
            assert (got != want).mean() < 0.01, key
        else:
            np.testing.assert_allclose(got, want, **FP32)


def test_hybrid_export_matches_jax(hybrid_pair):
    jrec, prec = _exports(hybrid_pair, _prompt(19))
    assert [p["layer"] for p in prec["ssm_state"]] == \
        [p["layer"] for p in jrec["ssm_state"]]
    for pp, jp in zip(prec["ssm_state"], jrec["ssm_state"]):
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(_np(pp[name]), np.asarray(jp[name]),
                                       **FP32)
    np.testing.assert_allclose(_np(prec["k"]), np.asarray(jrec["k"]), **FP32)


def test_export_mid_prefill_returns_none(llama_pair):
    eng = GenerationEngine(llama_pair[1], **ENGINE)
    assert eng.add_request(GenerationRequest("mid", _prompt(9), 4))
    assert eng.export_request("mid") is None       # prompt not paged in
    assert eng.export_request("unknown") is None
    _first_token(eng, "mid")
    assert eng.export_request("mid") is not None
    eng.evict("mid", "handoff")
    assert [r.request_id for r in eng.reap_finished()] == ["mid"]
    assert eng.cache.free_blocks == eng.cache.num_blocks


# ------------------------------------------------------------ wire format
def _synthetic(kind, seed=0):
    """A record with random arrays, once as the JAX package holds them
    (numpy, ml_dtypes) and once as the port does (torch)."""
    rng = np.random.RandomState(seed)
    meta = dict(version=3, request_id="w0", prompt=[1, 2, 3],
                generated=[4], max_new_tokens=8, temperature=0.7, top_k=5,
                top_p=0.9, eos_token_id=None, seed=11, seq_len=3,
                block_refs=[1], kv_quant=None, trace=None)
    shape = (2, 3, 2, 8)
    if kind == "bf16":
        k = rng.randn(*shape).astype(ml_dtypes.bfloat16)
        v = rng.randn(*shape).astype(ml_dtypes.bfloat16)
        arrays = dict(k=k, v=v)
    elif kind == "fp32":
        arrays = dict(k=rng.randn(*shape).astype(np.float32),
                      v=rng.randn(*shape).astype(np.float32))
    elif kind in ("int8", "fp8"):
        meta["kv_quant"] = kind
        if kind == "int8":
            k = rng.randint(-127, 128, size=shape).astype(np.int8)
            v = rng.randint(-127, 128, size=shape).astype(np.int8)
        else:
            k = rng.randn(*shape).astype(ml_dtypes.float8_e4m3fn)
            v = rng.randn(*shape).astype(ml_dtypes.float8_e4m3fn)
        arrays = dict(k=k, v=v,
                      k_scale=rng.rand(*shape[:3]).astype(np.float32),
                      v_scale=rng.rand(*shape[:3]).astype(np.float32))
    else:                               # hybrid: pages and SSM planes
        arrays = dict(k=rng.randn(*shape).astype(np.float32),
                      v=rng.randn(*shape).astype(np.float32))
        planes = [{"layer": li,
                   "conv": rng.randn(3, 40).astype(np.float32),
                   "ssm": rng.randn(4, 16, 8).astype(np.float32)}
                  for li in (0, 1)]
        jrec = dict(meta, **arrays, ssm_state=planes)
        prec = dict(meta, **{k: to_torch(a) for k, a in arrays.items()},
                    ssm_state=[{"layer": p["layer"],
                                "conv": to_torch(p["conv"]),
                                "ssm": to_torch(p["ssm"])} for p in planes])
        return jrec, prec
    jrec = dict(meta, **arrays)
    prec = dict(meta, **{k: _to_port(a) for k, a in arrays.items()})
    return jrec, prec


def _to_port(a):
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return to_torch(a)


def _array_keys(rec):
    keys = ["k", "v"] + (["k_scale", "v_scale"]
                         if rec.get("kv_quant") else [])
    return keys


@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8", "fp8", "hybrid"])
def test_wire_format_is_the_jax_packages_in_both_directions(kind):
    jrec, prec = _synthetic(kind)
    jax_blob, pt_blob = jax_kvh.pack_handoff(jrec), pt_kvh.pack_handoff(prec)
    assert pt_blob == jax_blob                  # the same bytes
    from_jax = pt_kvh.unpack_handoff(jax_blob)
    from_port = jax_kvh.unpack_handoff(pt_blob)
    for key in _array_keys(jrec):
        assert _bits(_np(from_jax[key])) == _bits(jrec[key]), key
        assert _bits(from_port[key]) == _bits(jrec[key]), key
    for key in HEADER:
        assert from_jax[key] == jrec[key] == from_port[key], key
    if kind == "hybrid":
        for got, back, want in zip(from_jax["ssm_state"],
                                   from_port["ssm_state"],
                                   jrec["ssm_state"]):
            assert got["layer"] == back["layer"] == want["layer"]
            for name in ("conv", "ssm"):
                assert _bits(_np(got[name])) == _bits(want[name])
                assert _bits(back[name]) == _bits(want[name])
    # repacking what was unpacked gives the blob back
    assert pt_kvh.pack_handoff(from_jax) == jax_blob


@pytest.mark.parametrize("kw", [{}, dict(kv_quant="int8")])
def test_exported_records_cross_the_wire_both_ways(llama_pair, kw):
    """Real exports: the port's packed record unpacks in JAX with its
    arrays bit for bit, and JAX's in the port."""
    jrec, prec = _exports(llama_pair, _prompt(30, seed=5), **kw)
    back = jax_kvh.unpack_handoff(pt_kvh.pack_handoff(prec))
    forth = pt_kvh.unpack_handoff(jax_kvh.pack_handoff(jrec))
    for key in _array_keys(jrec):
        assert _bits(back[key]) == _bits(_np(prec[key])), key
        assert _bits(_np(forth[key])) == _bits(np.asarray(jrec[key])), key


# -------------------------------------------------------- install, decode
def test_handoff_decode_equals_one_engine_bitwise(llama_pair):
    """Prefill on A, export after the first token, pages back on A's free
    list, the wire round trip, install on B with the same contents and
    refcounts; B's stream equals one engine's run bit for bit, no leak."""
    pm = llama_pair[1]
    prompt = _prompt(23, seed=9)
    ref = GenerationEngine(pm, **ENGINE).generate(
        [GenerationRequest("h", prompt, max_new_tokens=10)])["h"]
    a = GenerationEngine(pm, **ENGINE)
    assert a.add_request(GenerationRequest("h", prompt, max_new_tokens=2))
    _first_token(a, "h")
    rec = a.export_request("h")
    assert rec["seq_len"] == len(prompt) and len(rec["generated"]) == 1
    blocks = -(-rec["seq_len"] // a.cache.block_size)
    assert rec["block_refs"] == [1] * blocks
    a.evict("h", "handoff")
    a.reap_finished()
    assert a.cache.free_blocks == a.cache.num_blocks
    back = pt_kvh.unpack_handoff(pt_kvh.pack_handoff(rec))
    assert torch.equal(back["k"], rec["k"]) and torch.equal(back["v"],
                                                            rec["v"])
    back["max_new_tokens"] = 10
    b = GenerationEngine(pm, **ENGINE)
    req = b.import_request(back)
    slots = torch.as_tensor(b.cache.slot_mapping(req.slot, 0, len(prompt))
                            .astype(np.int64))
    assert torch.equal(b.cache.k.index_select(1, slots), rec["k"])
    assert b.cache.block_refs(req.slot)[:blocks] == rec["block_refs"]
    while b.num_active:
        b.step()
    assert req.output_ids == ref and req.finish_reason == "length"
    assert b.cache.free_blocks == b.cache.num_blocks


def test_sampled_handoff_keeps_the_seed_and_counter(llama_pair):
    """A sampled request's noise hashes (seed, position): the record
    carries the engine-assigned seed, so the continuation is the one
    engine's."""
    pm = llama_pair[1]
    prompt = _prompt(17, seed=4)
    kw = dict(temperature=0.9, top_p=0.95)
    one = GenerationEngine(pm, **ENGINE)
    one._seed_counter = 5
    ref = one.generate([GenerationRequest("s", prompt, max_new_tokens=8,
                                          **kw)])["s"]
    a = GenerationEngine(pm, **ENGINE)
    a._seed_counter = 5
    assert a.add_request(GenerationRequest("s", prompt, max_new_tokens=2,
                                           **kw))
    _first_token(a, "s")
    rec = pt_kvh.unpack_handoff(pt_kvh.pack_handoff(a.export_request("s")))
    assert rec["seed"] == 5
    rec["max_new_tokens"] = 8
    b = GenerationEngine(pm, **ENGINE)
    req = b.import_request(rec)
    while b.num_active:
        b.step()
    assert req.output_ids == ref


def test_install_without_capacity_keeps_the_record_usable(llama_pair):
    pm = llama_pair[1]
    a = GenerationEngine(pm, **ENGINE)
    assert a.add_request(GenerationRequest("cap", list(range(1, 8)), 2))
    _first_token(a, "cap")
    rec = a.export_request("cap")
    b = GenerationEngine(pm, **{**ENGINE, "max_seqs": 1})
    assert b.add_request(GenerationRequest("hog", list(range(1, 6)), 64))
    free = b.cache.free_blocks
    assert b.import_request(dict(rec)) is None      # no free slot
    assert b.cache.free_blocks == free              # nothing leaked
    b.evict("hog", "drained")
    assert b.import_request(dict(rec)) is not None  # the record still good


def test_hybrid_and_attention_only_mismatch_refused(llama_pair,
                                                    hybrid_pair):
    _, hrec = _exports(hybrid_pair, _prompt(12))
    _, lrec = _exports(llama_pair, _prompt(12))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lb = GenerationEngine(llama_pair[1], **ENGINE)
        hb = GenerationEngine(hybrid_pair[1], **ENGINE)
        assert lb.import_request(hrec) is None
        assert hb.import_request(lrec) is None
    for eng in (lb, hb):
        assert eng.cache.free_blocks == eng.cache.num_blocks
    assert hb.import_request(hrec) is not None


def test_hybrid_handoff_decode_equals_one_engine(hybrid_pair):
    pm = hybrid_pair[1]
    prompt = _prompt(15, seed=6)
    ref = GenerationEngine(pm, **ENGINE).generate(
        [GenerationRequest("y", prompt, max_new_tokens=8)])["y"]
    a = GenerationEngine(pm, **ENGINE)
    assert a.add_request(GenerationRequest("y", prompt, max_new_tokens=2))
    rec = a.export_request("y")
    a.evict("y", "handoff")
    rec = pt_kvh.unpack_handoff(pt_kvh.pack_handoff(rec))
    rec["max_new_tokens"] = 8
    b = GenerationEngine(pm, **ENGINE)
    req = b.import_request(rec)
    while b.num_active:
        b.step()
    assert req.output_ids == ref
    assert b.cache.free_blocks == b.cache.num_blocks


def test_device_route_is_off_on_the_cpu(llama_pair):
    eng = GenerationEngine(llama_pair[1], **ENGINE)
    assert pt_kvh.dma_handoff_enabled(eng) is False
    assert pt_kvh.dma_handoff_enabled() is False
    # a device-to-device record reaching a CPU engine is refused, with its
    # slot freed: no host falls back to another route
    rec = {"request_id": "x", "prompt": [1, 2], "generated": [3],
           "max_new_tokens": 4, "seq_len": 2, "block_refs": [1],
           "kv_quant": None, "ipc": {"segments": []}}
    with pytest.raises(pt_kvh.HandoffRefused):
        eng.import_request(rec)
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert eng.num_active == 0


# ------------------------------------------------------------------ #18
def test_remote_copy_twin_between_two_gloo_ranks(tmp_path):
    """#18's twin on two spawned gloo CPU ranks: the source's pages land on
    the destination bit for bit, for bf16 pages, int8 pages and fp32
    scales, at one and two chunks."""
    import _torch_fleet_ranks
    from paddle_tpu_torch import distributed as pt_dist
    pt_dist.spawn(_torch_fleet_ranks.remote_copy_run, (str(tmp_path),),
                  nprocs=2, timeout=120)
    for r in range(2):
        got = torch.load(tmp_path / f"copy{r}.pt")
        assert got and all(g["equal_source"] and g["moved"]
                           and g["launches"] == 0 for g in got), got


def test_remote_copy_refuses_without_a_group():
    pages = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="no process group"):
        pt_k18.kv_pages_remote_copy(pages, 0, 1)
    with pytest.raises(ValueError, match="no process group"):
        pt_k18.kv_pages_remote_copy_plain(pages, 0, 1)


def test_remote_copy_chunks_clamp_as_the_reference():
    assert pt_k18.clamp_chunks(2, 32768) == 2
    assert pt_k18.clamp_chunks(4, 6) == 3
    assert pt_k18.clamp_chunks(5, 3) == 3
    assert pt_k18.clamp_chunks(0, 7) == 1
