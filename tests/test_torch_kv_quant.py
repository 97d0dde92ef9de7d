"""The port's quantized serving memory plane (int8/fp8 KV pages, weight-only
int8) against the JAX package's.

Inputs are made with numpy from seeds; weights by the JAX models (seeded),
carried across with ``load_jax_state``. The JAX quantized ragged kernel
(``paddle_tpu/ops/pallas/quant.py``) runs in interpret mode on the CPU, as
``tests/test_kv_quant.py`` runs it; on the CPU the port's kernel wrappers
run their plain twins. Tolerances follow ``tests/op_harness.py``: fp32
rtol 1e-5, atol 2e-6 (softmaxes over up to 128 keys summed in another
order), bf16 2e-2. Quantized values are compared exactly, except that an
int8 value may differ by 1 (and an fp8 value by one e4m3 step) on at most
0.1% of the entries, where an fp32 input computed in another order by the
two frameworks lands on the other side of a rounding boundary; on the
inputs here they come out equal. Token streams are compared exactly.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu.inference.attention import \
    ragged_attention_xla as jax_ragged_xla
from paddle_tpu.inference.engine import GenerationEngine as JaxEngine
from paddle_tpu.inference.engine import GenerationRequest as JaxRequest
from paddle_tpu.inference.paged_cache import PagedKVCache as JaxCache
from paddle_tpu.models import HybridSSMForCausalLM as JaxHybrid
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny_config as jax_llama_tiny
from paddle_tpu.models import ssm_tiny_config as jax_ssm_tiny
from paddle_tpu.ops.pallas import quant as jax_qp
from paddle_tpu.quantization import kv as jkv
from paddle_tpu.quantization.observers import \
    abs_max_scale as jax_abs_max_scale
from paddle_tpu_torch import flags
from paddle_tpu_torch.inference import (GenerationEngine, GenerationRequest,
                                        PagedKVCache, gather_paged_scales,
                                        paged_attention_ragged,
                                        ragged_attention_xla)
from paddle_tpu_torch.inference import decode_step as pt_ds
from paddle_tpu_torch.inference import engine as pt_engine
from paddle_tpu_torch.models import (HybridSSMForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, SSMConfig)
from paddle_tpu_torch.ops.kernels import quant as pq
from paddle_tpu_torch.quantization import abs_max_scale
from paddle_tpu_torch.quantization import kv as pkv
from paddle_tpu_torch.weights import load_jax_state

FP32 = dict(rtol=1e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
MODES = ["int8", "fp8"]
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8], [11, 22, 33, 44, 55]]
ENGINE = dict(max_seqs=4, max_seq_len=128, block_size=16)


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _to_torch(a):
    """A JAX array as a torch tensor of the same dtype (fp8 through a byte
    view, which numpy cannot hand to torch directly)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_quantized_close(got, want, mode):
    """Quantized values equal, but for a step of 1 (int8) or one e4m3 step
    (fp8) on at most 0.1% of the entries."""
    g, w = _f64(got), _f64(want)
    diff = np.abs(g - w)
    step = 1.0 if mode == "int8" else np.maximum(np.abs(w), 2.0 ** -9) / 8
    assert np.all(diff <= step + 1e-12), float(diff.max())
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def _rows(shape, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * rs.rand(*shape[:-1], 1) * 4).astype(np.float32)
    x.reshape(-1, shape[-1])[[1, 5]] = 0.0          # two zero rows
    return x


# ---------------------------------------------------------------- math
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,dtype", [((6, 5, 4, 16), "float32"),
                                         ((33, 2, 64), "float32"),
                                         ((7, 8, 128), "bfloat16")])
def test_quantize_kv_matches_jax(mode, shape, dtype):
    x = _rows(shape, seed=len(shape) + shape[-1])
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, js = jkv.quantize_kv(jnp.asarray(x, jd), mode)
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = pkv.quantize_kv(px, mode)
    assert q.dtype == pkv.storage_dtype(mode) and s.dtype == torch.float32
    assert tuple(q.shape) == shape and tuple(s.shape) == shape[:-1]
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _assert_quantized_close(q.float(), jq, mode)
    # zero rows: scale 0, values 0, dequant exactly 0
    flat_q, flat_s = q.float().reshape(-1, shape[-1]), s.reshape(-1)
    assert float(flat_s[[1, 5]].abs().max()) == 0.0
    assert float(flat_q[[1, 5]].abs().max()) == 0.0
    back = pkv.dequantize_kv(q, s)
    assert float(back.reshape(-1, shape[-1])[[1, 5]].abs().max()) == 0.0
    # dequant of the same values and scales is the same arithmetic
    want = jkv.dequantize_kv(jnp.asarray(_f64(q), jnp.float32)
                             .astype(jq.dtype), js)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_int8_matches_jax(dtype):
    rs = np.random.RandomState(4)
    w = (rs.randn(64, 48) * rs.rand(1, 48)).astype(np.float32)
    w[:, 5] = 0.0                                    # a zero column
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, js = jkv.quantize_weight_int8(jnp.asarray(w, jd))
    q, s = pkv.quantize_weight_int8(torch.from_numpy(w).to(
        getattr(torch, dtype)))
    assert q.dtype == torch.int8 and tuple(s.shape) == (48,)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _assert_quantized_close(q, np.asarray(jq), "int8")
    assert float(s[5]) == 0.0 and int(q[:, 5].abs().max()) == 0


@pytest.mark.parametrize("dim,bits", [(None, 8), (0, 8), (-1, 8), (0, 4)])
def test_abs_max_scale_matches_jax(dim, bits):
    x = np.random.RandomState(5).randn(12, 9).astype(np.float32)
    want = jax_abs_max_scale(jnp.asarray(x), axis=dim, bit_length=bits)
    got = abs_max_scale(torch.from_numpy(x), dim=dim, bit_length=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("value,want", [
    (None, None), ("off", None), ("none", None), ("", None), (False, None),
    ("auto", "int8"), ("on", "int8"), ("int8", "int8"), ("fp8", "fp8"),
    (" INT8 ", "int8")])
def test_resolve_mode_table(value, want):
    assert pkv.resolve_mode(value) == want == jkv.resolve_mode(value)


def test_resolve_mode_refuses_unknown_modes():
    for value in ("int4", "bf16"):
        with pytest.raises(ValueError):
            jkv.resolve_mode(value)
        with pytest.raises(ValueError):
            pkv.resolve_mode(value)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("kv,d", [(2, 8), (8, 64), (8, 128)])
def test_page_row_bytes_matches_jax(mode, kv, d):
    jdt = jkv.storage_dtype(mode) if mode else jnp.bfloat16
    pdt = pkv.storage_dtype(mode) if mode else torch.bfloat16
    assert pkv.page_row_bytes(kv, d, pdt, mode) == jkv.page_row_bytes(
        kv, d, jdt, mode)


# --------------------------------------------------------------- cache
@pytest.mark.parametrize("mode,dtype", [("int8", None), ("fp8", None),
                                        (None, "bfloat16"),
                                        (None, "float32")])
def test_cache_bytes_per_block_matches_jax(mode, dtype):
    jdt = getattr(jnp, dtype) if dtype else jnp.float32
    pdt = getattr(torch, dtype) if dtype else torch.float32
    j = JaxCache(2, 8, 4, 2, 8, 4, dtype=jdt, quant=mode)
    p = PagedKVCache(2, 8, 4, 2, 8, 4, dtype=pdt, quant=mode)
    assert p.bytes_per_block == j.bytes_per_block
    assert p.quant == j.quant


@pytest.mark.parametrize("mode", MODES)
def test_cache_write_matches_jax_and_frees_clean(mode):
    """The same rows written at the same slots of both caches: pages and
    scales equal everywhere (scales at the pages' slots, zero elsewhere),
    the layer views dequantize to the rows, and freeing every slot leaks
    no block."""
    layers, nb, bs, kv, d = 2, 8, 4, 2, 16
    j = JaxCache(layers, nb, bs, kv, d, 4, quant=mode)
    p = PagedKVCache(layers, nb, bs, kv, d, 4, quant=mode)
    rs = np.random.RandomState(6)
    for c in (j, p):
        s0, s1 = c.allocate_slot(), c.allocate_slot()
        assert c.ensure_capacity(s0, 6) and c.ensure_capacity(s1, 9)
    assert p.free_blocks == j.free_blocks == nb - 5
    slots = np.concatenate([j.slot_mapping(0, 0, 6), j.slot_mapping(1, 0, 9)])
    np.testing.assert_array_equal(slots, np.concatenate(
        [p.slot_mapping(0, 0, 6), p.slot_mapping(1, 0, 9)]))
    for li in range(layers):
        k = rs.randn(len(slots), kv, d).astype(np.float32) * (li + 1)
        v = rs.randn(len(slots), kv, d).astype(np.float32)
        j.write(li, jnp.asarray(k), jnp.asarray(v), slots)
        p.write(li, torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(slots))
        pk, pv, pks, pvs = p.layer(li)
        assert pk.dtype == pkv.storage_dtype(mode)
        assert tuple(pks.shape) == (nb * bs, kv)
        for got, ref in ((pkv.dequantize_kv(pk[slots], pks[slots]), k),
                         (pkv.dequantize_kv(pv[slots], pvs[slots]), v)):
            bound = 0.5 / 127 if mode == "int8" else 1 / 16
            err = np.abs(got.numpy() - ref)
            assert np.all(err <= bound * np.abs(ref).max(-1,
                                                         keepdims=True)
                          + 1e-6)
    rows = nb * bs
    for side in ("k", "v"):
        _assert_quantized_close(getattr(p, side)[:, :rows].float(),
                                getattr(j, side), mode)
        ps = getattr(p, f"{side}_scale")
        np.testing.assert_array_equal(ps[:, :rows].numpy(),
                                      np.asarray(getattr(j, f"{side}_scale")))
        written = np.zeros(rows, bool)
        written[slots] = True
        assert float(ps[:, :rows][:, written].abs().min()) > 0
        assert float(ps[:, :rows][:, ~written].abs().max()) == 0
    # a pad token aimed at the sentinel writes the spare row only
    before = p.k_scale[:, :rows].clone()
    p.write(0, torch.ones(1, kv, d), torch.ones(1, kv, d),
            torch.tensor([p.sentinel]))
    assert torch.equal(p.k_scale[:, :rows], before)
    assert float(p.k_scale[0, p.sentinel].min()) > 0
    for c in (j, p):
        c.free_slot(0)
        c.free_slot(1)
    assert p.free_blocks == p.num_blocks == j.free_blocks


def test_unquantized_cache_layer_has_no_scales():
    c = PagedKVCache(1, 2, 4, 1, 8, 1)
    k, v, ks, vs = c.layer(0)
    assert ks is None and vs is None and c.k_scale is None
    assert tuple(k.shape) == (8, 1, 8)


# ------------------------------------------------------- the #10 twin
def _quant_inputs(mode, t, max_seqs, width, bs, kv, hq, d, seed,
                  pads=(), q_dtype="float32"):
    """Pages quantized by the JAX package from seeded fp32 rows, tables,
    rows and valids: the same values for both frameworks."""
    rs = np.random.RandomState(seed)
    n_rows = (max_seqs * width + 1) * bs
    kf = rs.randn(n_rows, kv, d).astype(np.float32)
    vf = rs.randn(n_rows, kv, d).astype(np.float32)
    kq, ks = jkv.quantize_kv(jnp.asarray(kf), mode)
    vq, vs = jkv.quantize_kv(jnp.asarray(vf), mode)
    tables = (1 + rs.permutation(max_seqs * width)).reshape(
        max_seqs, width).astype(np.int32)
    rows = rs.randint(0, max_seqs, size=t).astype(np.int32)
    valids = rs.randint(1, width * bs + 1, size=t).astype(np.int32)
    valids[list(pads)] = 0
    q = rs.randn(t, hq, d).astype(np.float32)
    jd = jnp.bfloat16 if q_dtype == "bfloat16" else jnp.float32
    jargs = (jnp.asarray(q, jd), kq, vq, ks, vs, jnp.asarray(tables),
             jnp.asarray(rows), jnp.asarray(valids))
    pargs = (torch.from_numpy(q).to(getattr(torch, q_dtype)), _to_torch(kq),
             _to_torch(vq), _to_torch(ks), _to_torch(vs),
             torch.from_numpy(tables), torch.from_numpy(rows),
             torch.from_numpy(valids))
    return jargs, pargs


def test_twin_matches_jax_pallas_kernel():
    """d=128, group 2 (hq 4 over kv 2), int8 pages, two pad tokens: the
    JAX kernel in interpret mode against the port's wrapper (its twin on
    the CPU); live tokens at the fp32 tier, the port's pads exactly 0."""
    t, bs = 9, 8
    jargs, pargs = _quant_inputs("int8", t, 3, 4, bs, 2, 4, 128, seed=7,
                                 pads=(2, 8))
    assert jax_qp.eligible(jargs[0].shape, 2, 128, jargs[1].dtype)
    want = jax_qp.ragged_paged_attention_quant(*jargs, bs)
    got = pq.ragged_paged_attention_quant(*pargs, bs)
    live = _f64(pargs[-1]) > 0
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, 4, 128)
    np.testing.assert_allclose(_f64(got)[live], _f64(want)[live], **FP32)
    assert float(got[~torch.from_numpy(live)].abs().max()) == 0.0


@pytest.mark.parametrize("mode,d,kv,hq,q_dtype", [
    ("int8", 64, 2, 4, "float32"), ("fp8", 64, 2, 8, "float32"),
    ("fp8", 128, 2, 4, "float32"), ("int8", 64, 4, 4, "bfloat16")])
def test_twin_matches_jax_composed_path(mode, d, kv, hq, q_dtype):
    """The reference's composed dequant path (``ragged_attention_xla`` with
    ``k_scale``/``v_scale``), where its kernel does not go: head_dim 64
    and fp8 pages. Pads left out (the reference's composed path averages
    there; the port's twin gives 0)."""
    t, bs = 10, 16
    jargs, pargs = _quant_inputs(mode, t, 4, 3, bs, kv, hq, d, seed=8,
                                 pads=(4,), q_dtype=q_dtype)
    q, kq, vq, ks, vs, tables, rows, valids = jargs
    want = jax_ragged_xla(q, kq, vq, tables, rows, valids, bs,
                          k_scale=ks, v_scale=vs)
    p = pargs
    got = ragged_attention_xla(p[0], p[1], p[2], p[5], p[6], p[7], bs,
                               k_scale=p[3], v_scale=p[4])
    public = paged_attention_ragged(p[0], p[1], p[2], np.array(tables),
                                    np.array(rows), np.array(valids), bs,
                                    k_scale=p[3], v_scale=p[4])
    assert torch.equal(got, public) and got.dtype == p[0].dtype
    live = np.asarray(valids) > 0
    tol = FP32 if q_dtype == "float32" else BF16
    np.testing.assert_allclose(_f64(got)[live], _f64(want)[live], **tol)
    assert float(got[4].abs().max()) == 0.0


def test_gather_paged_scales_matches_jax():
    from paddle_tpu.inference.attention import \
        gather_paged_scales as jax_gather
    rs = np.random.RandomState(9)
    scales = rs.rand(6 * 4, 3).astype(np.float32)
    tables = rs.randint(0, 6, size=(2, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_paged_scales(torch.from_numpy(scales),
                            torch.from_numpy(tables), 4).numpy(),
        np.asarray(jax_gather(jnp.asarray(scales), jnp.asarray(tables), 4)))


@pytest.mark.parametrize("q_shape,kv,d,page,ok", [
    ((4, 4, 128), 2, 128, torch.int8, True),
    ((4, 4, 64), 2, 64, torch.int8, True),
    ((4, 8, 64), 1, 64, torch.float8_e4m3fn, True),
    ((4, 4, 96), 2, 96, torch.int8, True),
    ((4, 6, 128), 4, 128, torch.int8, False),
    ((4, 64, 128), 1, 128, torch.int8, False),
    ((4, 4, 128), 2, 128, torch.bfloat16, False),
    ((4, 4, 256), 2, 256, torch.float8_e4m3fn, True),
    ((4, 4, 72), 2, 72, torch.int8, False)])
def test_kernel_eligible(q_shape, kv, d, page, ok):
    """A head_dim that is a multiple of 16 up to 256 (72 is refused),
    whole GQA groups of at most 32 query heads, int8 or fp8 pages (the
    reference's kernel: int8 and d % 128 == 0)."""
    assert pq.eligible(q_shape, kv, d, page) is ok


def test_quant_wrapper_does_not_fall_back_off_cuda():
    """A tensor neither on the CPU nor on a CUDA device gets an error,
    never the plain twin."""
    m = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pq.ragged_paged_attention_quant(
            torch.empty(2, 4, 64, **m),
            torch.empty(16, 2, 64, dtype=torch.int8, **m),
            torch.empty(16, 2, 64, dtype=torch.int8, **m),
            torch.empty(16, 2, **m), torch.empty(16, 2, **m),
            torch.empty(1, 2, dtype=torch.int32, **m),
            torch.empty(2, dtype=torch.int32, **m),
            torch.empty(2, dtype=torch.int32, **m), 8)


# ---------------------------------------------------- the slice, whole
def _np_state(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


def _port_config(jcfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg) if f.name in names})


@pytest.fixture(scope="module")
def llama_pair():
    """A seeded tiny fp32 JAX Llama and the port's copy of it (CPU)."""
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


def _greedy(n=10):
    return [(i, p, dict(max_new_tokens=n)) for i, p in enumerate(PROMPTS)]


def _jax_run(model, reqs, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = JaxEngine(model, **{**ENGINE, **kw})
        return eng, eng.generate([JaxRequest(*r[:2], **r[2]) for r in reqs])


def _port_run(model, reqs, **kw):
    eng = GenerationEngine(model, **{**ENGINE, **kw})
    return eng, eng.generate([GenerationRequest(*r[:2], **r[2])
                              for r in reqs])


@pytest.mark.parametrize("kw", [
    dict(kv_quant="int8"), dict(kv_quant="fp8"), dict(weight_quant=True),
    dict(kv_quant="int8", weight_quant=True)],
    ids=["int8", "fp8", "weight_int8", "int8+weight_int8"])
def test_compiled_engine_matches_jax(llama_pair, kw):
    """The JAX compiled engine and the port's, token for token; the KV
    pages and scales they leave behind equal (pads excluded: the port
    writes them to its sentinel row, the reference drops them)."""
    jm, pm = llama_pair
    jeng, jout = _jax_run(jm, _greedy(), mode="compiled", **kw)
    peng, pout = _port_run(pm, _greedy(), mode="compiled", **kw)
    assert pout == jout
    assert all(len(v) == 10 for v in pout.values())
    assert (peng.kv_quant, peng.weight_quant, peng.cache.quant) == (
        jeng.kv_quant, jeng.weight_quant, jeng.cache.quant)
    assert peng.cache.free_blocks == peng.cache.num_blocks
    mode = peng.kv_quant
    if mode is None:
        return
    rows = jeng.cache.k.shape[1]
    for side in ("k", "v"):
        _assert_quantized_close(getattr(peng.cache, side)[:, :rows].float(),
                                getattr(jeng.cache, side), mode)
        np.testing.assert_allclose(
            getattr(peng.cache, f"{side}_scale")[:, :rows].numpy(),
            np.asarray(getattr(jeng.cache, f"{side}_scale")), rtol=1e-5,
            atol=1e-8)


def test_weight_quant_params_match_jax(llama_pair):
    """``extract_params(weight_quant=True)``: the seven projections of each
    layer as ``{"q", "s"}`` equal to the reference's; the rest untouched
    (the model's own tensors)."""
    from paddle_tpu.inference import decode_step as jax_ds
    jm, pm = llama_pair
    jp = jax_ds.extract_params(jm, weight_quant=True)
    pp = pt_ds.extract_params(pm, weight_quant=True)
    for layer, jl, pl in zip(pm.llama.layers, jp["layers"], pp["layers"]):
        for name in pt_ds._WQ_NAMES:
            assert pl[name]["q"].dtype == torch.int8
            _assert_quantized_close(pl[name]["q"], np.asarray(jl[name]["q"]),
                                    "int8")
            np.testing.assert_array_equal(pl[name]["s"].numpy(),
                                          np.asarray(jl[name]["s"]))
        assert pl["ln1"] is layer.input_layernorm.weight
        assert pl["ln2"] is layer.post_attention_layernorm.weight
    assert pp["embed"] is pm.llama.embed_tokens.weight


def test_weight_quant_matmul_matches_jax():
    """``_mm`` on an int8 leaf: ``(x @ q) * s`` in x's dtype."""
    from paddle_tpu.inference import decode_step as jax_ds
    rs = np.random.RandomState(10)
    w = rs.randn(32, 24).astype(np.float32)
    x = rs.randn(5, 32).astype(np.float32)
    jq, js = jkv.quantize_weight_int8(jnp.asarray(w))
    want = jax_ds._mm(jnp.asarray(x), {"q": jq, "s": js})
    got = pt_ds._mm(torch.from_numpy(x), {"q": _to_torch(jq),
                                          "s": _to_torch(js)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f64(got), _f64(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------- the reference's contracts
@pytest.fixture
def reset_flags():
    yield
    flags.set_flags({"serve_kv_quant": "off", "serve_weight_quant": False})


def test_auto_flag_resolves_to_int8(llama_pair, reset_flags):
    _, pm = llama_pair
    flags.set_flags({"serve_kv_quant": "auto", "serve_weight_quant": True})
    eng = GenerationEngine(pm, **ENGINE)
    assert eng.kv_quant == "int8" and eng.weight_quant is True
    assert eng.cache.quant == "int8" and eng.cache.k.dtype == torch.int8


@pytest.mark.parametrize("kwargs,flag", [
    (dict(kv_quant="int8"), None), (dict(weight_quant=True), None),
    ({}, ("serve_kv_quant", "fp8")), ({}, ("serve_weight_quant", True))],
    ids=["kv_quant", "weight_quant", "flag_kv_quant_fp8",
         "flag_weight_quant"])
def test_quant_options_are_taken(llama_pair, reset_flags, kwargs, flag):
    """The options the port refused until the memory plane was ported,
    from an argument or from the flag: the engine takes them and serves."""
    _, pm = llama_pair
    if flag is not None:
        flags.set_flags({flag[0]: flag[1]})
    eng, out = _port_run(pm, _greedy(4), **kwargs)
    want = {"kv_quant": "int8"} if kwargs.get("kv_quant") else {}
    if flag and flag[0] == "serve_kv_quant":
        want = {"kv_quant": "fp8"}
    assert eng.kv_quant == want.get("kv_quant")
    assert eng.cache.quant == eng.kv_quant
    assert eng.weight_quant is bool(kwargs.get("weight_quant") or (
        flag and flag[0] == "serve_weight_quant"))
    assert all(len(v) == 4 for v in out.values())
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_eager_mode_turns_quant_off_with_a_warning(llama_pair, monkeypatch):
    """Eager decode reads full-width pages with the model's own weights:
    both options go off with the reference's one-time warnings, and the
    stream equals the JAX eager engine's under the same options."""
    jm, pm = llama_pair
    monkeypatch.setattr(pt_engine, "_warned_fallbacks", set())
    kw = dict(mode="eager", kv_quant="int8", weight_quant=True)
    with pytest.warns(RuntimeWarning) as rec:
        eng, out = _port_run(pm, _greedy(6), **kw)
    text = " ".join(str(w.message) for w in rec)
    assert "kv quant" in text and "weight quant" in text
    assert eng.kv_quant is None and eng.weight_quant is False
    assert eng.cache.quant is None
    jeng, jout = _jax_run(jm, _greedy(6), **kw)
    assert jeng.kv_quant is None and jeng.weight_quant is False
    assert out == jout


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


def test_hybrid_turns_kv_quant_off_with_a_warning(hybrid_pair, monkeypatch):
    """A hybrid model turns ``kv_quant`` off with the reference's warning
    and keeps ``weight_quant`` (its attention layers' projections in int8),
    as the reference does; the stream equals the JAX hybrid engine's."""
    jm, pm = hybrid_pair
    monkeypatch.setattr(pt_engine, "_warned_fallbacks", set())
    kw = dict(mode="compiled", kv_quant="int8", weight_quant=True)
    with pytest.warns(RuntimeWarning, match="kv quant"):
        eng, out = _port_run(pm, _greedy(6), **kw)
    assert eng.kv_quant is None and eng.cache.quant is None
    assert eng.weight_quant is True
    assert isinstance(eng._params["layers"][2]["wq"], dict)   # attention
    assert "wq" not in eng._params["layers"][0]                # SSM
    jeng, jout = _jax_run(jm, _greedy(6), **kw)
    assert (jeng.kv_quant, jeng.weight_quant) == (None, True)
    assert out == jout
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_make_step_refuses_kv_quant_with_ssm():
    with pytest.raises(ValueError, match="kv_quant"):
        pt_ds.make_step(object(), 16, ssm=[None], kv_quant="int8")


def test_step_refuses_a_cache_of_another_quant(llama_pair):
    """A step made for int8 pages refuses a full-width cache (and the
    reverse) instead of reading its pages as the wrong type."""
    _, pm = llama_pair
    step = pt_ds.make_step(pm.config, 16, kv_quant="int8")
    cache = PagedKVCache(2, 4, 16, 2, 16, 2)
    with pytest.raises(ValueError, match="quant"):
        step(1, None, cache, None, *([None] * 16))
