"""The port's hybrid attention+SSM model and its serving, and the eager
engine, against the JAX package.

Weights are made by the JAX models (seeded) and carried across with
``load_jax_state``; prompts come from numpy. The JAX scan runs its Pallas
kernel in interpret mode (``pallas_selective_scan=on``), as
``tests/test_ssm.py`` runs it; on the CPU the port's kernel wrappers run
their plain twins. Tolerances follow ``tests/op_harness.py``: fp32 rtol
1e-5, with atol 1e-5 in place of 1e-6 because logits and states are sums
over widths of 64-296 taken in another order; bf16 2e-2. Token streams
are compared exactly.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu.inference import decode_step as jax_ds
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.inference.engine import GenerationRequest as JaxRequest
from paddle_tpu.models import HybridSSMForCausalLM as JaxHybrid
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_llama_tiny
from paddle_tpu.models import ssm_tiny_config as jax_ssm_tiny
from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
from paddle_tpu_torch.inference import decode_step as pt_ds
from paddle_tpu_torch.models import (HybridSSMForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, SSMConfig)
from paddle_tpu_torch.weights import load_jax_state

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [11, 22, 33, 44, 55]]
ENGINE = dict(max_seqs=4, max_seq_len=128, block_size=16)


@pytest.fixture(scope="module", autouse=True)
def _jax_chunked_scan():
    old = jax_flags.flag("pallas_selective_scan")
    jax_flags.set_flags({"pallas_selective_scan": "on"})
    yield
    jax_flags.set_flags({"pallas_selective_scan": old})


def _np_state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


def _port_config(jcfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg) if f.name in names})


def _hybrid_pair(dtype="float32", seed=0, **kw):
    """A seeded JAX tiny hybrid (SSAS by default, as the JAX serving tests
    use) and the port's copy of it on the CPU."""
    kw = {"num_hidden_layers": 4, "layer_pattern": "SSA", **kw}
    paddle.seed(seed)
    jcfg = jax_ssm_tiny(dtype=dtype, **kw)
    jm = JaxHybrid(jcfg)
    jm.eval()
    pm = HybridSSMForCausalLM(_port_config(jcfg, SSMConfig), device="cpu")
    load_jax_state(pm, _np_state(jm))
    return jm, pm


@pytest.fixture(scope="module")
def fp32_pair():
    return _hybrid_pair("float32")


@pytest.fixture(scope="module")
def llama_pair():
    paddle.seed(7)
    jcfg = jax_llama_tiny(num_hidden_layers=2, hidden_size=64,
                          intermediate_size=128, num_attention_heads=4,
                          num_key_value_heads=2, vocab_size=128,
                          max_position_embeddings=256)
    jm = JaxLlama(jcfg)
    jm.eval()
    pm = LlamaForCausalLM(_port_config(jcfg, LlamaConfig), device="cpu")
    load_jax_state(pm, _np_state(jm))
    return jm, pm


def _jax_generate(model, mode, reqs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = JaxEngine(model, mode=mode, **ENGINE)
        return eng.generate([JaxRequest(*r[:2], **r[2]) for r in reqs])


def _port_generate(model, mode, reqs, **kw):
    eng = GenerationEngine(model, mode=mode, **{**ENGINE, **kw})
    return eng, eng.generate([GenerationRequest(*r[:2], **r[2])
                              for r in reqs])


GREEDY = [(i, p, dict(max_new_tokens=12)) for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def jax_hybrid_outputs(fp32_pair):
    jm, _ = fp32_pair
    return {mode: _jax_generate(jm, mode, GREEDY)
            for mode in ("compiled", "eager")}


# ------------------------------------------------------------- weights
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_state_on_the_hybrid(dtype):
    """Keys and shapes one to one and every value bitwise. Norms and the
    mixer's dt_bias, A_log, D and norm_weight are fp32 in the port; the
    JAX bf16 hybrid keeps the latter four bf16, which widen exactly."""
    jm, pm = _hybrid_pair(dtype, seed=11)
    state = _np_state(jm)
    params = dict(pm.named_parameters())
    assert set(params) == set(state)
    fp32 = ("layernorm.weight", "llama.norm.weight", "mixer.dt_bias",
            "mixer.A_log", "mixer.D", "mixer.norm_weight")
    for name, p in params.items():
        src = state[name]
        assert tuple(p.shape) == src.shape, name
        want = "float32" if name.endswith(fp32) else dtype
        assert str(p.dtype) == f"torch.{want}", name
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      src.astype(np.float32), err_msg=name)
    assert params["llama.layers.0.mixer.in_proj.weight"].shape == (64, 296)
    with pytest.raises(KeyError):
        load_jax_state(pm, {k: v for k, v in state.items()
                            if "A_log" not in k})


# -------------------------------------------------------------- model
def test_hybrid_logits_match_jax_fp32(fp32_pair):
    jm, pm = fp32_pair
    ids = np.random.RandomState(0).randint(0, 256, size=(2, 37))
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float64)
    with torch.no_grad():
        out = pm(torch.from_numpy(ids)).double().numpy()
    np.testing.assert_allclose(out, ref, **FP32)


def test_hybrid_logits_match_jax_bf16():
    """bf16 at the bf16 tier (the port's RMSNorm keeps x's dtype, the
    reference's composed CPU path promotes; ROADMAP.md section C)."""
    jm, pm = _hybrid_pair("bfloat16", seed=3, num_hidden_layers=2,
                          layer_pattern="SA")
    ids = np.random.RandomState(1).randint(0, 256, size=(1, 21))
    ref = np.asarray(jm(paddle.to_tensor(ids)).astype("float32").numpy(),
                     np.float64)
    with torch.no_grad():
        out = pm(torch.from_numpy(ids)).double().numpy()
    np.testing.assert_allclose(out, ref, **BF16)


def test_hybrid_loss_and_training_shapes_on_the_cpu(fp32_pair):
    """With labels, the fp32 shifted loss of the JAX model; the CPU twins
    keep the forward differentiable."""
    jm, pm = fp32_pair
    ids = np.random.RandomState(2).randint(0, 256, size=(2, 16))
    jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    loss, shifted = pm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert shifted.shape == (2, 15, 256)
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    loss.backward()
    g = pm.llama.layers[0].mixer.in_proj.weight.grad
    assert g is not None and bool(torch.isfinite(g).all())
    pm.zero_grad(set_to_none=True)


def test_forward_with_state_matches_jax(fp32_pair):
    """The prefill form: the mixer's output, its conv state and its fp32
    SSD state, for a prompt that is no multiple of the chunk."""
    jm, pm = fp32_pair
    x = np.random.RandomState(4).randn(2, 45, 64).astype(np.float32)
    jo, jconv, jssm = jm.llama.layers[0].mixer.forward_with_state(
        paddle.to_tensor(x))
    with torch.no_grad():
        po, pconv, pssm = pm.llama.layers[0].mixer.forward_with_state(
            torch.from_numpy(x))
    assert tuple(pconv.shape) == (2, 3, 160)
    assert tuple(pssm.shape) == (2, 8, 16, 16)
    for got, want in ((po, jo.numpy()), (pconv, jconv.numpy()),
                      (pssm, jssm)):
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(want, np.float64), **FP32)


def test_ssm_layer_step_matches_jax(fp32_pair):
    """One decode step of an SSM layer from a random carried state."""
    jm, pm = fp32_pair
    rs = np.random.RandomState(5)
    h = rs.randn(3, 64).astype(np.float32)
    conv = rs.randn(3, 3, 160).astype(np.float32)
    ssm = rs.randn(3, 8, 16, 16).astype(np.float32)
    jspec = jax_ds.extract_ssm_specs(jm)[0]
    pspec = pt_ds.extract_ssm_specs(pm)[0]
    assert jspec == pspec
    jout = jax_ds.ssm_layer_step(
        jnp.asarray(h), jax_ds.extract_params(jm)["layers"][0], jspec,
        jnp.asarray(conv), jnp.asarray(ssm), 1e-5)
    with torch.no_grad():
        pout = pt_ds.ssm_layer_step(
            torch.from_numpy(h), pt_ds.extract_params(pm)["layers"][0],
            pspec, torch.from_numpy(conv), torch.from_numpy(ssm), 1e-5)
    for got, want in zip(pout, jout):
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(want, np.float64), **FP32)


# ------------------------------------------------------------- engines
@pytest.mark.parametrize("mode", ["compiled", "eager"])
def test_hybrid_engine_greedy_matches_jax(fp32_pair, jax_hybrid_outputs,
                                          mode):
    _, pm = fp32_pair
    eng, out = _port_generate(pm, mode, GREEDY)
    assert eng.mode == mode and eng.is_hybrid
    assert out == jax_hybrid_outputs[mode]


def test_hybrid_compiled_equals_eager_and_drains_clean(fp32_pair):
    """Compiled and eager agree token for token; the KV cache holds the
    attention layers only (SSAS: 1); every slot's state is zero and every
    page free after the drain; ``auto`` takes the compiled step."""
    _, pm = fp32_pair
    outs = {}
    for mode in ("auto", "eager"):
        eng, outs[mode] = _port_generate(pm, mode, GREEDY)
        assert eng.cache.k.shape[0] == 1 == eng.cache.num_layers
        assert eng.ssm_state_bytes() == 3 * 4 * (3 * 160 + 8 * 16 * 16) * 4
        for st in eng._sstate:    # the pads' spare row is no slot's
            if st is not None:
                assert float(st["conv"][:4].abs().sum()) == 0.0
                assert float(st["ssm"][:4].abs().sum()) == 0.0
        assert eng.cache.free_blocks == eng.cache.num_blocks
    assert eng.mode == "eager"
    assert outs["auto"] == outs["eager"]


def test_evict_zeroes_state_and_readmit_parity(fp32_pair,
                                               jax_hybrid_outputs):
    """(``tests/test_ssm.py:341-362``) An evicted request hands back a
    zeroed slot and its pages; a request readmitted there decodes as a
    fresh engine does. While it runs, the free slot's rows stay zero:
    pad tokens write only the spare row."""
    _, pm = fp32_pair
    eng = GenerationEngine(pm, mode="compiled", max_seqs=2,
                           max_seq_len=128, block_size=16)
    r = GenerationRequest(0, PROMPTS[0], max_new_tokens=50)
    assert eng.add_request(r)
    for _ in range(3):
        eng.step()
    slot = r.slot
    assert float(eng._sstate[0]["ssm"][slot].abs().sum()) > 0
    assert float(eng._sstate[0]["ssm"][1 - slot].abs().sum()) == 0.0
    assert eng.evict(0, "shed") and not eng.evict(0)
    assert r.finish_reason == "shed"
    for st in eng._sstate:
        if st is not None:
            assert float(st["ssm"][:2].abs().sum()) == 0.0
            assert float(st["conv"][:2].abs().sum()) == 0.0
    assert eng.cache.free_blocks == eng.cache.num_blocks
    out = eng.generate([GenerationRequest(1, PROMPTS[1], max_new_tokens=12)])
    assert out[1] == jax_hybrid_outputs["compiled"][1]


def test_dense_eager_greedy_and_sampled_match_jax(llama_pair):
    """The eager engine on a dense Llama: greedy rows token for token, and
    sampled rows too, since both engines draw from a host
    ``RandomState(0)`` over the same logits."""
    jm, pm = llama_pair
    reqs = [(0, [5, 9, 3, 1], dict(max_new_tokens=8)),
            (1, [7, 8, 1, 2, 3, 4, 5, 6, 7, 1, 2],
             dict(max_new_tokens=8, temperature=0.8, top_k=20, top_p=0.9)),
            (2, [1, 2, 3], dict(max_new_tokens=8, temperature=1.0))]
    want = _jax_generate(jm, "eager", reqs)
    eng, got = _port_generate(pm, "eager", reqs)
    assert got == want
    assert eng.mode == "eager" and eng._sstate is None
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_dense_eager_equals_compiled_greedy(llama_pair):
    _, pm = llama_pair
    reqs = [(i, p, dict(max_new_tokens=8)) for i, p in enumerate(PROMPTS)]
    assert (_port_generate(pm, "eager", reqs)[1]
            == _port_generate(pm, "compiled", reqs)[1])


def test_hybrid_eager_sampled_matches_jax(fp32_pair):
    jm, pm = fp32_pair
    reqs = [(0, PROMPTS[0], dict(max_new_tokens=6, temperature=0.9,
                                 top_p=0.8)),
            (1, PROMPTS[2], dict(max_new_tokens=6, temperature=1.2,
                                 top_k=10))]
    assert _port_generate(pm, "eager", reqs)[1] == \
        _jax_generate(jm, "eager", reqs)


def test_unported_options_raise_for_hybrids(fp32_pair, jax_hybrid_outputs,
                                            monkeypatch):
    """Speculative decode, the prefix cache and the host KV tier on a
    hybrid: as in the reference, each is turned off with its one-time
    warning, in both modes, and the engine serves on; the streams equal the
    JAX hybrid engine's without them. (The name is kept from when the port
    refused these options.)"""
    from paddle_tpu_torch.inference import engine as pt_engine
    _, pm = fp32_pair
    for mode in ("compiled", "eager"):
        monkeypatch.setattr(pt_engine, "_warned_fallbacks", set())
        with pytest.warns(RuntimeWarning) as rec:
            eng, out = _port_generate(pm, mode, GREEDY, spec_tokens=2,
                                      prefix_cache=True, host_tier=True)
        text = " ".join(str(w.message) for w in rec)
        for what in ("speculative decode", "prefix cache", "kv host tier"):
            assert what in text, (mode, what, text)
        assert eng.spec_tokens == 0 and not eng._prefix_on
        assert eng.cache.host_tier is None
        assert out == jax_hybrid_outputs[mode]
        assert eng.cache.free_blocks == eng.cache.num_blocks
