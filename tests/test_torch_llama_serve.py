"""The port's Llama model and compiled serving path against the JAX
package.

Weights are made by the JAX model (seeded) and carried across with
``load_jax_state``; prompts are made with numpy. On the CPU the port's
kernel wrappers run their plain twins. Tolerances follow
``tests/op_harness.py``: fp32 rtol 1e-5 / atol 1e-6, bf16 2e-2; logits
are compared at fp32 atol 1e-5 (stated below where used).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationEngine as JaxEngine
from paddle_tpu.inference import GenerationRequest as JaxRequest
from paddle_tpu.inference import decode_step as jax_ds
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
from paddle_tpu_torch.inference import decode_step as pt_ds
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_jax_state

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)


def _np_state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


def _pair(dtype="float32", seed=7):
    """A seeded JAX tiny Llama and the port's copy of it (CPU)."""
    paddle.seed(seed)
    jcfg = jax_tiny_config(dtype=dtype, **TINY)
    jm = JaxLlama(jcfg)
    jm.eval()
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    pcfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name in names})
    pm = LlamaForCausalLM(pcfg, device="cpu")
    load_jax_state(pm, _np_state(jm))
    return jm, pm


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair("float32")


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair("bfloat16")


def _prompts(lens, vocab=128, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lens]


def _engine(model, **kw):
    kw.setdefault("max_seqs", 4)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("block_size", 16)
    return GenerationEngine(model, **kw)


# ------------------------------------------------------------- weights
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_state_round_trips(dtype):
    """Keys, shapes and dtypes match one to one (norms fp32, the rest in
    the config dtype) and every value crosses bitwise."""
    jm, pm = _pair(dtype, seed=11)
    state = _np_state(jm)
    params = dict(pm.named_parameters())
    assert set(params) == set(state)
    for name, p in params.items():
        src = state[name]
        assert tuple(p.shape) == src.shape
        want = "float32" if name.endswith("layernorm.weight") or \
            name == "llama.norm.weight" else dtype
        assert str(p.dtype) == f"torch.{want}", name
        back = p.detach().view(torch.int16 if p.dtype == torch.bfloat16
                               else p.dtype).numpy()
        raw = src.view(np.int16) if src.dtype.name == "bfloat16" else src
        assert np.array_equal(back, raw), name
    assert params["llama.layers.0.self_attn.q_proj.weight"].shape == (64, 64)
    assert params["llama.layers.0.self_attn.k_proj.weight"].shape == (64, 32)
    with pytest.raises(KeyError):
        load_jax_state(pm, {k: v for k, v in state.items()
                            if "lm_head" not in k})


# -------------------------------------------------------------- logits
def test_logits_match_jax_fp32(fp32_pair):
    # fp32 logits: atol 1e-5, since matmuls and reductions sum in another
    # order than XLA's over two layers and a 64-wide head
    jm, pm = fp32_pair
    ids = np.random.RandomState(0).randint(0, 128, size=(2, 11))
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float64)
    out = pm(torch.from_numpy(ids)).double().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_logits_match_jax_bf16(bf16_pair):
    """bf16 model at the bf16 tier. The port's RMSNorm keeps x's dtype
    (the TPU kernel's contract) where the reference's composed CPU path
    promotes to fp32 (ROADMAP.md section C)."""
    jm, pm = bf16_pair
    ids = np.random.RandomState(1).randint(0, 128, size=(1, 13))
    ref = np.asarray(jm(paddle.to_tensor(ids)).astype("float32").numpy(),
                     np.float64)
    out = pm(torch.from_numpy(ids)).double().numpy()
    np.testing.assert_allclose(out, ref, **BF16)


# ------------------------------------------------ compiled step, bf16 flow
def _one_prompt_step_inputs(prompt, bs=16, num_blocks=4, t_b=16):
    n = len(prompt)
    block = 2
    ints = dict(
        ids=prompt + [0] * (t_b - n),
        positions=list(range(n)) + [0] * (t_b - n),
        rows=[0] * t_b,
        wslots=[block * bs + i for i in range(n)]
        + [num_blocks * bs] * (t_b - n),
        valids=list(range(1, n + 1)) + [0] * (t_b - n))
    tables = np.zeros((2, num_blocks), np.int32)
    tables[0, 0] = block
    tail = dict(row_slots=[0], out_idx=[[n - 1]], draft_next=np.zeros(
        (1, 0), np.int32), n_spec=[0], seeds=[0], counters=[0], temps=[0.0],
        top_ks=[0], top_ps=[1.0])
    return ints, tables, tail


def test_step_bf16_dtype_flow_matches_jax(bf16_pair, monkeypatch):
    """One prefill step of a bf16 model: the logits the sampler sees come
    out fp32 on both sides (the residual stream turns fp32 at the first
    norm, K/V are stored bf16) and agree at the bf16 tier."""
    import jax.numpy as jnp
    jm, pm = bf16_pair
    prompt = _prompts([10])[0]
    ints, tables, tail = _one_prompt_step_inputs(prompt)
    seen = {}

    def capture(name, argmax):
        def fake(logits, *rest):
            seen[name] = logits
            return argmax(logits)
        return fake

    monkeypatch.setattr(jax_ds, "sample_tokens", capture(
        "jax", lambda lg: jnp.argmax(lg, -1).astype(jnp.int32)))
    monkeypatch.setattr(pt_ds, "sample_tokens", capture(
        "port", lambda lg: lg.argmax(-1).to(torch.int32)))

    cfg = jm.config
    kc = jnp.zeros((2, 4 * 16, 2, 16), jnp.bfloat16)
    jstep = jax_ds.make_step(cfg, 16, use_kernel=False)
    jargs = [jnp.asarray(np.asarray(v, np.int32)) for v in ints.values()]
    jtail = [jnp.asarray(np.asarray(v, np.float32 if k in ("temps", "top_ps")
                                    else np.int32)) for k, v in tail.items()]
    kc2, vc2, jtok, _ = jstep(1, jax_ds.extract_params(jm), kc, kc,
                              *jargs[:4], jnp.asarray(tables), jtail[0],
                              jargs[4], *jtail[1:])

    cache = PagedKVCache(2, 4, 16, 2, 16, 2, dtype=torch.bfloat16)
    pstep = pt_ds.make_step(pm.config, 16)
    pargs = [torch.tensor(v, dtype=torch.int32) for v in ints.values()]
    ptail = [torch.as_tensor(np.asarray(v), dtype=torch.float32
                             if k in ("temps", "top_ps") else torch.int32)
             for k, v in tail.items()]
    ptok, _ = pstep(1, pt_ds.extract_params(pm), cache, *pargs[:4],
                    torch.from_numpy(tables), ptail[0], pargs[4], *ptail[1:])

    assert seen["jax"].dtype == jnp.float32
    assert seen["port"].dtype == torch.float32
    assert cache.k.dtype == torch.bfloat16
    np.testing.assert_allclose(seen["port"].double().numpy(),
                               np.asarray(seen["jax"], np.float64), **BF16)
    # the K rows the step wrote agree too (bf16 pages, block 2)
    jk = np.asarray(kc2[:, 32:42].astype(jnp.float32))
    np.testing.assert_allclose(cache.k[:, 32:42].float().numpy(), jk,
                               **BF16)


# ------------------------------------------------------------- engines
def test_engine_greedy_matches_jax_compiled_engine(fp32_pair):
    jm, pm = fp32_pair
    prompts = _prompts([5, 9, 3])
    jeng = JaxEngine(jm, mode="compiled", max_seqs=4, max_seq_len=128,
                     block_size=16)
    ref = jeng.generate([JaxRequest(i, p, max_new_tokens=6)
                         for i, p in enumerate(prompts)])
    out = _engine(pm).generate([GenerationRequest(i, p, max_new_tokens=6)
                                for i, p in enumerate(prompts)])
    assert out == ref


def test_engine_greedy_matches_naive_forward(fp32_pair):
    _, pm = fp32_pair
    prompt = _prompts([7])[0]
    ids = list(prompt)
    for _ in range(8):
        logits = pm(torch.tensor([ids]))
        ids.append(int(logits[0, -1].argmax()))
    out = _engine(pm).generate([GenerationRequest(0, prompt,
                                                  max_new_tokens=8)])
    assert out[0] == ids[len(prompt):]


def test_chunked_prefill_is_bitwise(fp32_pair):
    """Chunked prefill interleaved with decode reproduces the one-chunk
    prefill bit for bit, greedy and seeded sampling alike, with the token
    bucket floored so every step has the same shapes."""
    _, pm = fp32_pair
    prompts = _prompts([11, 6])
    outs = {}
    for chunk in (64, 3):
        eng = _engine(pm, prefill_chunk=chunk, token_bucket_floor=32)
        reqs = [GenerationRequest(0, prompts[0], max_new_tokens=6),
                GenerationRequest(1, prompts[1], max_new_tokens=6,
                                  temperature=0.8, top_k=20, top_p=0.95,
                                  seed=2)]
        outs[chunk] = eng.generate(reqs, return_details=True)
    assert outs[3] == outs[64]


def test_seeded_streams_repeat(fp32_pair):
    _, pm = fp32_pair
    prompts = _prompts([8, 12, 5], seed=9)

    def run():
        return _engine(pm).generate(
            [GenerationRequest(i, p, max_new_tokens=5, temperature=1.0,
                               top_p=0.9, seed=40 + i)
             for i, p in enumerate(prompts)])
    assert run() == run()


def test_finish_reasons_and_no_page_leak(fp32_pair):
    _, pm = fp32_pair
    prompt = _prompts([5])[0]
    eng = _engine(pm)
    det = eng.generate([GenerationRequest(0, prompt, max_new_tokens=3)],
                       return_details=True)
    assert det[0]["finish_reason"] == "length"
    first = det[0]["output_ids"][0]
    det = eng.generate([GenerationRequest(1, prompt, max_new_tokens=8,
                                          eos_token_id=first)],
                       return_details=True)
    assert det[1] == {"output_ids": [first], "finish_reason": "eos",
                      "error": None}
    assert eng.cache.free_blocks == eng.cache.num_blocks
    # one 16-token block in all: decode runs off the end of the pool
    eng = _engine(pm, max_seqs=1, num_blocks=1)
    det = eng.generate([GenerationRequest(0, _prompts([10])[0],
                                          max_new_tokens=30)],
                       return_details=True)
    assert det[0]["finish_reason"] == "cache_exhausted"
    assert 0 < len(det[0]["output_ids"]) < 30
    assert eng.cache.free_blocks == eng.cache.num_blocks
    # a prompt that can never fit is rejected up front
    eng = _engine(pm, max_seqs=2, num_blocks=2)
    det = eng.generate([GenerationRequest(0, _prompts([40])[0],
                                          max_new_tokens=4),
                        GenerationRequest(1, prompt, max_new_tokens=4)],
                       return_details=True, max_steps=50)
    assert det[0]["finish_reason"] == "rejected"
    assert "never" in det[0]["error"]
    assert det[1]["finish_reason"] == "length"
    assert eng.stats["steps"] <= 10
    assert eng.cache.free_blocks == eng.cache.num_blocks


# ------------------------------------------------------------ sampling
def _sample(lg, temps, top_ks, top_ps, seeds, counters):
    return pt_ds.sample_tokens(
        torch.as_tensor(lg), torch.as_tensor(temps, dtype=torch.float32),
        torch.as_tensor(top_ks, dtype=torch.int32),
        torch.as_tensor(top_ps, dtype=torch.float32),
        torch.as_tensor(seeds, dtype=torch.int32),
        torch.as_tensor(counters, dtype=torch.int32)).numpy()


def test_greedy_and_top_k_one_rows():
    rng = np.random.RandomState(1)
    lg = rng.randn(8, 32).astype(np.float32)
    greedy = _sample(lg, np.zeros(8), np.zeros(8), np.ones(8), np.zeros(8),
                     np.zeros(8))
    top1 = _sample(lg, np.full(8, 0.7), np.ones(8), np.ones(8),
                   np.arange(8), np.zeros(8))
    np.testing.assert_array_equal(greedy, lg.argmax(-1))
    np.testing.assert_array_equal(top1, lg.argmax(-1))


def test_sampling_reproducible_across_batching():
    """A row's draw depends only on (seed, counter): alone, or as row 2
    of a batch of other seeds and counters, the token is the same."""
    rng = np.random.RandomState(2)
    lg = rng.randn(1, 64).astype(np.float32)
    for seed, counter in ((5, 3), (123, 0), (7, 999)):
        alone = _sample(lg, [0.9], [0], [1.0], [seed], [counter])
        batch = _sample(np.tile(lg, (4, 1)), np.full(4, 0.9), np.zeros(4),
                        np.ones(4), [1, 2, seed, 4], [8, 9, counter, 11])
        assert alone[0] == batch[2]


def _numpy_truncated_probs(arr, temperature, top_k, top_p):
    """The reference host sampler's distribution (engine._sample_host)."""
    z = arr / temperature
    if top_k and top_k < len(z):
        kth = np.partition(z, -top_k)[-top_k]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max()
    p = np.exp(z) / np.exp(z).sum()
    if top_p < 1.0:
        order = np.argsort(-p)
        cut = int(np.searchsorted(np.cumsum(p[order]), top_p)) + 1
        keep = np.zeros_like(p, dtype=bool)
        keep[order[:cut]] = True
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    return p


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8),
                                         (6, 0.9)])
def test_distribution_matches_numpy(top_k, top_p):
    """Empirical frequencies of 4000 draws (counters 0..3999) match the
    reference host sampler's truncated softmax, with the same support."""
    arr = np.random.RandomState(4).randn(12).astype(np.float32) * 2.0
    n = 4000
    toks = _sample(np.tile(arr, (n, 1)), np.full(n, 0.9), np.full(n, top_k),
                   np.full(n, top_p), np.zeros(n), np.arange(n))
    emp = np.bincount(toks, minlength=12) / n
    ref = _numpy_truncated_probs(arr, 0.9, top_k, top_p)
    assert set(np.nonzero(emp)[0]) <= set(np.nonzero(ref)[0])
    np.testing.assert_allclose(emp, ref, atol=0.04)
