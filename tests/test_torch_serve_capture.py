"""The compiled serving step as the reference compiles it: one
``to_static`` program per bucket signature, against the JAX package.

The reference traces its decode step once per combination of buckets
(table width, tokens, rows, outputs) and counts the traces
(``decode_signatures``, with ``obs_metrics`` on). The port runs the step
as a ``jit.to_static`` program per signature: on the CPU a program's
first call runs the step, its second records what a capture would, and
every later call runs the step under the recorded guards and staging (the
card replays a CUDA graph there; ``tests/test_torch_cuda.py`` holds that
against the eager arm). Weights are made by the JAX models (seeded) and
carried across with ``load_jax_state``; prompts come from numpy. Token
streams are compared exactly; signature counts must be equal.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu import observability as jax_obs
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.inference.engine import GenerationRequest as JaxRequest
from paddle_tpu.models import HybridSSMForCausalLM as JaxHybrid
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.models import llama_tiny_config as jax_llama_tiny
from paddle_tpu.models import ssm_tiny_config as jax_ssm_tiny
from paddle_tpu_torch import jit as pt_jit
from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
from paddle_tpu_torch.models import (HybridSSMForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, SSMConfig)
from paddle_tpu_torch.weights import load_jax_state

ENGINE = dict(max_seqs=4, max_seq_len=128, block_size=16, mode="compiled")
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)
MOE_TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=8, max_position_embeddings=256,
                moe_num_experts=4, moe_capacity_factor=2.0)


def _np_state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


def _port_config(jcfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg) if f.name in names})


def _pair(kind):
    """A seeded JAX tiny model (eval) and the port's copy of it (CPU)."""
    if kind == "hybrid":
        paddle.seed(0)
        jcfg = jax_ssm_tiny(dtype="float32", num_hidden_layers=4,
                            layer_pattern="SSA")
        jm, cls, pcls = JaxHybrid(jcfg), HybridSSMForCausalLM, SSMConfig
    elif kind == "moe":
        paddle.seed(35)
        jcfg = jax_llama.LlamaConfig(dtype="float32", **MOE_TINY)
        jm, cls, pcls = JaxLlama(jcfg), LlamaForCausalLM, LlamaConfig
    else:
        paddle.seed(7)
        jcfg = jax_llama_tiny(**TINY)
        jm, cls, pcls = JaxLlama(jcfg), LlamaForCausalLM, LlamaConfig
    jm.eval()
    pm = cls(_port_config(jcfg, pcls), device="cpu")
    load_jax_state(pm, _np_state(jm))
    pm.eval()
    return jm, pm


@pytest.fixture(scope="module")
def dense_pair():
    return _pair("dense")


@pytest.fixture
def jax_obs_on():
    """The reference counts signatures only with ``obs_metrics`` on."""
    jax_flags.set_flags({"obs_metrics": True})
    yield
    jax_flags.set_flags({"obs_metrics": False, "obs_jsonl_dir": ""})
    jax_obs.metrics().clear()
    jax_obs.reset()


@pytest.fixture(autouse=True)
def _to_static_on():
    yield
    pt_jit.enable_to_static(True)


def _prompts(n, vocab, lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=l).tolist() for l in lens[:n]]


def _engines(pair, **kw):
    jm, pm = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        je = JaxEngine(jm, **{**ENGINE, **kw})
    return je, GenerationEngine(pm, **{**ENGINE, **kw})


def _generate(eng, request_cls, specs):
    """``specs``: ``(request_id, prompt, kwargs)``."""
    return eng.generate([request_cls(rid, p, **kw) for rid, p, kw in specs])


def _both(je, pe, specs):
    """The same requests through both engines; the streams must agree."""
    ref = _generate(je, JaxRequest, specs)
    out = _generate(pe, GenerationRequest, specs)
    assert out == ref
    return out


def _replayed(eng):
    """Every program is its signature's, and some program ran past its
    recording call (calls the card replays)."""
    progs = eng._program.concrete_programs()
    assert len(progs) == eng.decode_signatures()
    assert all(p.reason is None for p in progs)
    return max(p.calls for p in progs)


# ------------------------------------------- the reference's bucket tests
def test_bucket_signatures_equal_jax_and_a_repeat_adds_none(dense_pair,
                                                            jax_obs_on):
    """``tests/test_decode_step.py:172-194`` on both engines: a growing
    workload makes at most one signature per bucket combination (at most
    8), the same count as the JAX engine's traces, and the same profile
    again makes none; every stream token for token JAX's."""
    je, pe = _engines(dense_pair, prefill_chunk=4, token_bucket_floor=4)

    def run(n_reqs, seed):
        prompts = _prompts(n_reqs, 128, (3, 5, 6, 7), seed=seed)
        _both(je, pe, [((seed, i), p, dict(max_new_tokens=4))
                       for i, p in enumerate(prompts)])

    for n in (1, 2, 3, 4):
        run(n, seed=n)
    warm = pe.decode_signatures()
    assert 0 < warm <= 8
    assert warm == je.decode_signatures()
    steps = pe.stats["steps"]
    run(4, seed=99)
    assert pe.stats["steps"] > steps
    assert pe.decode_signatures() == warm == je.decode_signatures()
    assert _replayed(pe) >= 3
    assert pe.capture_stats()["programs"] == warm


def test_draft_signatures_equal_jax_and_a_repeat_adds_none(dense_pair,
                                                           jax_obs_on):
    """``tests/test_spec_prefix.py:255-273`` on both engines: verify
    chunks of four drafts bucket like everything else (at most 12
    signatures, JAX's count), a second wave makes none, and every page
    comes back after the rollbacks."""
    je, pe = _engines(dense_pair, spec_tokens=4, token_bucket_floor=4)
    prompts = _prompts(4, 128, (6, 9, 12, 17), seed=5)
    _both(je, pe, [(i, p, dict(max_new_tokens=20))
                   for i, p in enumerate(prompts)])
    assert pe.stats["spec_drafted"] > 0
    assert pe.cache.free_blocks == pe.cache.num_blocks
    warm = pe.decode_signatures()
    assert 0 < warm <= 12
    assert warm == je.decode_signatures()
    _both(je, pe, [(100 + i, p, dict(max_new_tokens=20))
                   for i, p in enumerate(prompts)])
    assert pe.decode_signatures() == warm == je.decode_signatures()
    assert _replayed(pe) >= 3


# ----------------------------------------- later calls against JAX's
_CASES = {"dense": ("dense", {}), "int8": ("dense", dict(kv_quant="int8")),
          "moe": ("moe", {}), "hybrid": ("hybrid", {})}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_later_calls_match_jax(case):
    """A workload whose signatures recur (two waves of the same prompt
    lengths, greedy: the port's sampling noise is its own hash, not
    JAX's PRNG): the port's programs reach the calls that run the
    recorded plan, and every stream is the JAX compiled engine's token for
    token."""
    kind, kw = _CASES[case]
    old = jax_flags.flag("pallas_selective_scan")
    if kind == "hybrid":
        # the JAX scan through its Pallas kernel in interpret mode, as
        # tests/test_ssm.py runs it
        jax_flags.set_flags({"pallas_selective_scan": "on"})
    try:
        je, pe = _engines(_pair(kind), **kw)
        vocab = pe.cfg.vocab_size
        for wave in range(2):
            prompts = _prompts(3, vocab, (5, 9, 3), seed=8 + wave)
            _both(je, pe, [((wave, i), p, dict(max_new_tokens=8))
                           for i, p in enumerate(prompts)])
    finally:
        jax_flags.set_flags({"pallas_selective_scan": old})
    assert _replayed(pe) >= 3
    assert pe.cache.free_blocks == pe.cache.num_blocks


# -------------------------------------------------------- the guards
def test_load_jax_state_keeps_the_programs_a_replaced_tensor_adds_one(
        dense_pair):
    """``load_jax_state`` copies into the served model's tensors in place:
    the same workload meets the same programs. A KV plane replaced under
    the engine (another tensor, the old one's storage still there) makes
    a new program for each signature met after it, and the streams stay
    the same."""
    jm, pm = dense_pair
    eng = GenerationEngine(pm, **ENGINE)
    specs = [(i, p, dict(max_new_tokens=6))
             for i, p in enumerate(_prompts(3, 128, (5, 9, 3), seed=4))]
    first = _generate(eng, GenerationRequest, specs)
    progs = len(eng._program.concrete_programs())
    ptrs = [t.data_ptr() for t in eng._step_state()]
    load_jax_state(pm, _np_state(jm))
    assert [t.data_ptr() for t in eng._step_state()] == ptrs
    assert _generate(eng, GenerationRequest, specs) == first
    assert len(eng._program.concrete_programs()) == progs
    eng.cache.k = eng.cache.k.clone()
    assert _generate(eng, GenerationRequest, specs) == first
    assert len(eng._program.concrete_programs()) == 2 * progs
    assert eng.decode_signatures() == progs


def test_enable_to_static_false_runs_the_step_op_by_op(dense_pair):
    """The jit plane's one switch turns the engine's programs off: the
    step runs as it is written, the streams are the programs' and the
    signatures are still counted."""
    specs = [(i, p, dict(max_new_tokens=6, temperature=0.7 * (i % 2),
                         seed=i))
             for i, p in enumerate(_prompts(3, 128, (5, 9, 3), seed=6))]
    on = GenerationEngine(dense_pair[1], **ENGINE)
    ref = _generate(on, GenerationRequest, specs)
    pt_jit.enable_to_static(False)
    off = GenerationEngine(dense_pair[1], **ENGINE)
    assert _generate(off, GenerationRequest, specs) == ref
    assert off.capture_stats()["programs"] == 0
    assert off.decode_signatures() == on.decode_signatures() > 0


def test_eager_engine_counts_no_signature(dense_pair):
    """``decode_signatures`` is 0 in eager mode, as in the reference."""
    eng = GenerationEngine(dense_pair[1], **{**ENGINE, "mode": "eager"})
    eng.generate([GenerationRequest(0, [1, 2, 3], max_new_tokens=3)])
    assert eng.decode_signatures() == 0
    assert eng.capture_stats()["programs"] == 0


# ------------------------------------------------- threads and captures
def test_capture_gate_keeps_device_work_out_of_a_capture():
    """``jit.api``'s gate under contention (more threads than cores, a
    short switch interval): no thread is inside ``device_work`` while a
    capture holds the gate, and threads that capture from inside their
    own ``device_work`` (as an engine's step does) never wait on each
    other."""
    import os
    import sys
    import threading
    from paddle_tpu_torch.jit import api
    gate = api._CaptureGate()
    inside, seen, errors = [0], [], []
    lock = threading.Lock()

    def work(n, captures):
        try:
            for i in range(n):
                with gate.shared():
                    with lock:
                        inside[0] += 1
                    with gate.shared():         # re-entrant
                        pass
                    if captures and i % 5 == 0:
                        # it issues nothing while it waits to capture
                        with lock:
                            inside[0] -= 1
                        with gate.exclusive():
                            with lock:
                                seen.append(inside[0])
                        with lock:
                            inside[0] += 1
                    with lock:
                        inside[0] -= 1
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n_threads = min(2 * (os.cpu_count() or 2), 16)
        threads = [threading.Thread(target=work, args=(200, i % 2 == 0))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    # while a capture held the gate, no thread was doing device work
    assert seen and all(n == 0 for n in seen), seen
    assert inside[0] == 0 and not gate._shared and gate._owner is None


def test_steps_in_two_threads_record_only_their_own_state():
    """Two ``to_static`` functions called from two threads at once (as two
    serving engines in one process): each program's guards and state are
    its own function's, never the other thread's."""
    import sys
    import threading
    a, b = torch.zeros(4), torch.ones(4)

    def step_a(x):
        pt_jit.api.note_state(lambda: [a])
        pt_jit.api.host_guard(lambda: "a")
        return x + a

    def step_b(x):
        pt_jit.api.note_state(lambda: [b])
        pt_jit.api.host_guard(lambda: "b")
        return x * b

    fa = pt_jit.api.StaticFunction(step_a, name="a")
    fb = pt_jit.api.StaticFunction(step_b, name="b")
    errors = []

    def loop(f, x):
        try:
            for _ in range(300):
                f(x)
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=loop, args=(f, torch.ones(4)))
                   for f in (fa, fb, fa, fb)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    (pa,), (pb,) = fa.concrete_programs(), fb.concrete_programs()
    assert [g() for g, _ in pa.guards] == ["a"]
    assert [g() for g, _ in pb.guards] == ["b"]
    assert [t for fn in pa._state_fns for t in fn()] == [a]
    assert [t for fn in pb._state_fns for t in fn()] == [b]
    assert pa.calls + pb.calls == 1200


def test_a_dropped_engine_takes_its_programs_with_it(dense_pair):
    """The step's programs reach the engine through a weak reference: an
    engine dropped by its last owner frees its programs (on the card,
    their graphs and the engine's graph pool) at once, without waiting for
    the cycle collector."""
    import gc
    import weakref
    eng = GenerationEngine(dense_pair[1], **ENGINE)
    eng.generate([GenerationRequest(0, [1, 2, 3, 4], max_new_tokens=4)])
    assert eng.capture_stats()["programs"] > 0
    program = weakref.ref(eng._program)
    gc.disable()
    try:
        del eng
        assert program() is None
    finally:
        gc.enable()
