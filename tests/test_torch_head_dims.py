"""Head dims other than 64 and 128, and the routes the CUDA wrappers pick.

The kernels of #1-#4 and #8-#10 take every head dim that is a multiple of
16 up to 256 on the card (instantiated at a padded head dim); their plain
twins are what the CPU runs. Here the twins at head dim 96 are held against
the JAX package's own functions on the CPU (Pallas interpret mode), on the
same numpy inputs; #9's and #10's twins also at 256, against the JAX
package's Pallas kernels (which take ``d % 128 == 0``) and, at 96, against
the composed path the reference sends that head dim to. A tiny head-dim-96
Llama carried over by ``weights.load_jax_state`` is held against the JAX
model. The route
predicates are pure functions of shape and alignment, tested as such; the
CUDA kernels behind them are held against these twins on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Tolerances follow
``tests/op_harness.py``: fp32 rtol 1e-5 / atol 1e-6, bf16 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu.inference.attention import \
    paged_attention_decode as jax_decode
from paddle_tpu.inference.attention import \
    ragged_attention_xla as jax_ragged_xla
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.ops.pallas import paged_attention as jax_paged
from paddle_tpu.ops.pallas import quant as jax_quant
from paddle_tpu.ops.pallas import ragged_paged_attention as jax_ragged
from paddle_tpu.quantization import kv as jax_kvq
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch.distributed.sequence_parallel import _zigzag_seg
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import async_collectives as pt_ac
from paddle_tpu_torch.ops.kernels import flash_attention as pt_flash
from paddle_tpu_torch.ops.kernels import paged_attention as pt_paged
from paddle_tpu_torch.ops.kernels import quant as pt_quant
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as pt_ragged
from paddle_tpu_torch.weights import load_jax_state, to_torch

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
D = 96


@pytest.fixture(autouse=True)
def _full_fp32_products():
    """The JAX references run their products at full fp32 ("highest"),
    the precision of the twins' fp32 products, so that no CPU backend
    picks a rounder product for them."""
    with jax.default_matmul_precision("highest"):
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _pair(a, dtype):
    """The same numpy values as a jax array and a torch tensor."""
    ja = jnp.asarray(a, getattr(jnp, dtype))
    return ja, to_torch(np.asarray(ja))


def _close_scaled(port, ref, tol):
    """rtol, and atol times the tensor's largest magnitude (a gradient
    element is a long sum, off by the rounding of its terms)."""
    ref = _np(ref)
    np.testing.assert_allclose(_np(port), ref, rtol=tol["rtol"],
                               atol=tol["atol"] * np.abs(ref).max())


# ------------------------------------------------- #1 and #2 at head dim 96
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk", [(True, 40, 40), (False, 24, 40)])
def test_flash_twins_match_jax_at_head_dim_96(dtype, causal, sq, sk):
    """#1's twin (O and lse) and #2's twin through ``FlashAttention
    Function`` against the JAX kernel and its vjp at head dim 96, GQA
    4:2, lengths no 16-row block divides."""
    rng = np.random.RandomState(40)
    q, k, v, do = (_pair(rng.randn(2, s, h, D), dtype)
                   for s, h in ((sq, 4), (sk, 2), (sk, 2), (sq, 4)))
    ref_o, ref_lse = jax_flash.flash_attention_with_lse(
        q[0], k[0], v[0], is_causal=causal, block_q=16, block_k=16)
    o, lse = pt_flash.flash_attention_with_lse(q[1], k[1], v[1], causal)
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(o), _np(ref_o), **tol)
    np.testing.assert_allclose(_np(lse), _np(ref_lse), **FP32)

    ref_out, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(
        a, b, c, is_causal=causal, block_q=16, block_k=16), q[0], k[0], v[0])
    ref_g = vjp(do[0])
    ts = [t[1].clone().requires_grad_(True) for t in (q, k, v)]
    out = pt_flash.FlashAttentionFunction.apply(*ts, causal)
    grads = torch.autograd.grad(out, ts, do[1])
    np.testing.assert_allclose(_np(out), _np(ref_out), **tol)
    for g, r, t in zip(grads, ref_g, ts):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close_scaled(g, r, tol)


# ------------------------------------------------- #3 and #4 at head dim 96
def _seg_cases():
    for sp in (2, 4):
        c = 64 // (2 * sp)
        for idx, src in ((0, 0), (sp - 1, 0), (0, sp - 1)):
            yield pytest.param(2 * c, 2 * c, _zigzag_seg(idx, src, c, sp),
                               id=f"sp{sp}-rank{idx}-src{src}")
    yield pytest.param(24, 20, [5, 40, 13, 0, 33, 7], id="straddle-cross")


@pytest.mark.parametrize("sq,sk,seg", list(_seg_cases()))
def test_seg_twins_match_jax_at_head_dim_96(sq, sk, seg):
    """#3's and #4's twins against the JAX segment-causal kernel and its
    vjp (fed the forward's own lse) at head dim 96, GQA 4:2, over zig-zag
    descriptors and splits no tile divides; fp32 tier, the gradients with
    atol scaled by each one's largest magnitude (a dK element near zero
    is a sum of 96-term products, off by their rounding)."""
    rng = np.random.RandomState(sum(seg) + sq)
    q, k, v, do = (rng.randn(1, s, h, D).astype(np.float32)
                   for s, h in ((sq, 4), (sk, 2), (sk, 2), (sq, 4)))
    jseg = jnp.asarray(seg, jnp.int32)
    (o, lse), vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention_seg_with_lse(a, b, c, jseg),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [o, lse, *vjp((jnp.asarray(do), jnp.zeros_like(lse)))]
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    po, plse = pt_flash.flash_attention_seg_with_lse(qt, kt, vt, seg)
    got = [po, plse, *pt_flash.flash_attention_seg_bwd(qt, kt, vt, po, plse,
                                                       dot, seg)]
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(_np(a)), fin, err_msg=name)
        scale = np.abs(b[fin]).max() if name[0] == "d" else 1.0
        np.testing.assert_allclose(_np(a)[fin], b[fin], rtol=FP32["rtol"],
                                   atol=FP32["atol"] * scale, err_msg=name)


# ------------------------------------------------------------ #8 at 96
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_ragged_twin_matches_jax_at_head_dim_96(q_dtype, kv_dtype):
    """#8's twin against the JAX kernel (interpret mode) at head dim 96:
    a decode row, a 4-token prompt chunk, a long decode and a pad row over
    GQA 4:2 pages of 8 tokens."""
    rng = np.random.RandomState(41)
    bs, num_blocks = 8, 16
    kc = _pair(rng.randn(num_blocks * bs, 2, D), kv_dtype)
    vc = _pair(rng.randn(num_blocks * bs, 2, D), kv_dtype)
    tables = rng.permutation(num_blocks)[:12].reshape(3, 4).astype(np.int32)
    rows = np.asarray([0, 1, 1, 1, 1, 2, 0], np.int32)
    valids = np.asarray([13, 3, 4, 5, 6, 25, 0], np.int32)
    q = _pair(rng.randn(len(rows), 4, D), q_dtype)
    ref = jax_ragged.ragged_paged_attention(
        q[0], kc[0], vc[0], jnp.asarray(tables), jnp.asarray(rows),
        jnp.asarray(valids), bs)
    out = pt_ragged.ragged_paged_attention(
        q[1], kc[1], vc[1], torch.from_numpy(tables), torch.from_numpy(rows),
        torch.from_numpy(valids), bs)
    assert out.dtype == q[1].dtype
    np.testing.assert_allclose(_np(out), _np(ref),
                               **(FP32 if q_dtype == "float32" else BF16))
    assert float(out[-1].abs().max()) == 0.0


# ---------------------------------------------------- #9 at 96 and 256
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 256])
def test_paged_twin_matches_jax_at_edge_head_dims(d, dtype):
    """#9's twin (the eager engine's decode) against the reference at
    head dims 96 and 256, GQA 4:2, pages of 8 tokens: at 256 its Pallas
    kernel (interpret mode; it takes ``d % 128 == 0``), at 96 the composed
    path ``inference/attention.py`` sends that head dim to (the public op,
    with the kernel flag on)."""
    rng = np.random.RandomState(d)
    bs, nb = 8, 4
    lens = [13, 1, 32]
    kc = _pair(rng.randn((3 * nb + 1) * bs, 2, d), dtype)
    vc = _pair(rng.randn((3 * nb + 1) * bs, 2, d), dtype)
    q = _pair(rng.randn(3, 4, d), dtype)
    tables = (1 + rng.permutation(3 * nb)).reshape(3, nb).astype(np.int32)
    jlens = np.asarray(lens, np.int32)
    if d % 128 == 0:
        assert jax_paged.eligible(q[0].shape, 2, d)
        ref = jax_paged.paged_decode_attention(q[0], kc[0], vc[0],
                                               jnp.asarray(tables), jlens, bs)
    else:
        assert not jax_paged.eligible(q[0].shape, 2, d)
        old = jax_flags.flag("use_pallas_kernels")
        jax_flags.set_flags({"use_pallas_kernels": True})
        try:
            ref = jax_decode(paddle.to_tensor(np.asarray(q[0])), kc[0], vc[0],
                             tables, jlens, bs)
        finally:
            jax_flags.set_flags({"use_pallas_kernels": old})
    assert pt_paged.eligible(q[1].shape, 2, d)
    out = pt_paged.paged_decode_attention(
        q[1], kc[1], vc[1], torch.from_numpy(tables),
        torch.from_numpy(jlens), bs)
    assert out.dtype == q[1].dtype and tuple(out.shape) == (3, 4, d)
    np.testing.assert_allclose(_np(out), _np(ref),
                               **(FP32 if dtype == "float32" else BF16))


# --------------------------------------------------- #10 at 96 and 256
def _quant_pages(mode, rng, n_rows, d):
    """Pages quantized by the JAX package from seeded fp32 rows, as a JAX
    pair and the torch tensors of the same bytes."""
    kq, ks = jax_kvq.quantize_kv(
        jnp.asarray(rng.randn(n_rows, 2, d).astype(np.float32)), mode)
    pages = np.asarray(kq)
    if pages.dtype.name == "float8_e4m3fn":
        tq = torch.from_numpy(pages.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        tq = torch.from_numpy(pages.copy())
    return (kq, ks), (tq, torch.from_numpy(np.array(ks)))


@pytest.mark.parametrize("d,mode,q_dtype", [
    (96, "int8", "float32"), (96, "fp8", "float32"), (96, "int8", "bfloat16"),
    (256, "int8", "float32"), (256, "int8", "bfloat16"),
    (256, "fp8", "float32")])
def test_quant_twin_matches_jax_at_edge_head_dims(d, mode, q_dtype):
    """#10's twin (ragged attention over int8/fp8 pages) against the
    reference at head dims 96 and 256, GQA 4:2, pages of 8 tokens, decode
    rows and a prompt chunk: the reference's Pallas kernel (interpret
    mode) where it goes, int8 at 256; its composed dequant path
    (``ragged_attention_xla`` with the scales) elsewhere. Live tokens only
    (the composed path averages at a pad; the twin gives exactly 0)."""
    rng = np.random.RandomState(d + len(mode))
    bs, seqs, width = 8, 3, 4
    n_rows = (seqs * width + 1) * bs
    (jk, jks), (tk, tks) = _quant_pages(mode, rng, n_rows, d)
    (jv, jvs), (tv, tvs) = _quant_pages(mode, rng, n_rows, d)
    tables = (1 + rng.permutation(seqs * width)).reshape(
        seqs, width).astype(np.int32)
    rows = np.asarray([0, 1, 2, 2, 2, 2, 0], np.int32)
    valids = np.asarray([13, 32, 4, 5, 6, 7, 0], np.int32)
    q = _pair(rng.randn(len(rows), 4, d), q_dtype)
    jidx = (jnp.asarray(tables), jnp.asarray(rows), jnp.asarray(valids))
    if jax_quant.eligible(q[0].shape, 2, d, jk.dtype):
        assert d == 256 and mode == "int8"
        ref = jax_quant.ragged_paged_attention_quant(q[0], jk, jv, jks, jvs,
                                                     *jidx, bs)
    else:
        ref = jax_ragged_xla(q[0], jk, jv, *jidx, bs, k_scale=jks,
                             v_scale=jvs)
    assert pt_quant.eligible(q[1].shape, 2, d, tk.dtype)
    out = pt_quant.ragged_paged_attention_quant(
        q[1], tk, tv, tks, tvs, torch.from_numpy(tables),
        torch.from_numpy(rows), torch.from_numpy(valids), bs)
    assert out.dtype == q[1].dtype and tuple(out.shape) == tuple(q[1].shape)
    live = valids > 0
    np.testing.assert_allclose(_np(out)[live], _np(ref)[live],
                               **(FP32 if q_dtype == "float32" else BF16))
    assert float(out[-1].abs().max()) == 0.0


# ------------------------------------------------ a head-dim-96 Llama
def test_llama_at_head_dim_96_matches_jax():
    """A tiny Llama with 4:2 heads of 96 (hidden 384, 2 layers), fp32,
    built by the JAX package from a seed and carried over by
    ``load_jax_state``: logits and every parameter's gradient of a loss on
    them against JAX's (rtol 1e-5 / atol 1e-6 on the logits, the
    gradients with atol scaled by each one's largest magnitude), the
    composed decoder path on both sides (the fused block takes head dims
    64 and 128 only); no kernel launch on CPU tensors."""
    tiny = dict(num_hidden_layers=2, hidden_size=384, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
                max_position_embeddings=64)
    paddle.seed(25)
    jcfg = jax_llama.llama_tiny_config(dtype="float32", **tiny)
    jm = jax_llama.LlamaForCausalLM(jcfg)
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    pcfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name in names})
    assert pcfg.hidden_size // pcfg.num_attention_heads == D
    pm = LlamaForCausalLM(pcfg, device="cpu")
    load_jax_state(pm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(6).randint(0, 128, size=(2, 21)) \
        .astype("int32")
    old = jax_flags.flag("pallas_fused_block"), \
        pt_flags.flag("pallas_fused_block")
    jax_flags.set_flags({"pallas_fused_block": "off"})
    pt_flags.set_flags({"pallas_fused_block": "off"})
    kernels.reset_launch_counts()
    try:
        jl = jm(paddle.to_tensor(ids))
        paddle.mean(jl * jl).backward()
        pl = pm(torch.from_numpy(ids))
        (pl * pl).mean().backward()
    finally:
        jax_flags.set_flags({"pallas_fused_block": old[0]})
        pt_flags.set_flags({"pallas_fused_block": old[1]})
    np.testing.assert_allclose(_np(pl), np.asarray(jl.numpy(), np.float64),
                               **FP32)
    jgrads = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        ref = np.asarray(jgrads[name].grad.numpy(), np.float64)
        np.testing.assert_allclose(_np(p.grad), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


# ------------------------------------------------------------ the routes
def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor 2 bytes past a 16-byte-aligned start."""
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    out = flat[1:].view(shape)
    assert out.is_contiguous() and out.data_ptr() % 16 == 2
    return out


def test_forward_routes_by_shape_and_alignment():
    """#1 and #3 take #1's ``wgmma`` kernel in bf16 at head dim 64 or
    128 where TMA maps q, k and v (16-byte-aligned bases) and the grid's
    batch x heads and 128-row query tiles fit 65535; else the edge route
    (#2 and #4 likewise by their own predicate). Decided from dtypes,
    shapes and pointers alone, before any launch."""
    q = torch.zeros(1, 300, 16, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 300, 8, 64, dtype=torch.bfloat16)
    assert pt_flash._seg_fwd_tma_ok(1, 16, q, kv, kv)
    assert not pt_flash._seg_fwd_tma_ok(1, 16, _misaligned(q.shape), kv, kv)
    assert not pt_flash._seg_fwd_tma_ok(1, 16, q, kv, _misaligned(kv.shape))
    assert not pt_flash._seg_fwd_tma_ok(4096, 16, q, kv, kv)
    assert pt_flash._seg_fwd_tma_ok(4095, 16, q, kv, kv)
    # query tiles past the grid's 65535 (a view: no memory behind it)
    long_q = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(
        1, 128 * 65535 + 1, 1, 64)
    assert not pt_flash._seg_fwd_tma_ok(1, 1, long_q, kv, kv)
    assert pt_flash._seg_fwd_tma_ok(1, 1, long_q[:, :128 * 65535], kv, kv)
    for d, dtype, want in ((64, torch.bfloat16, True),
                           (128, torch.bfloat16, True),
                           (96, torch.bfloat16, False),
                           (256, torch.bfloat16, False),
                           (64, torch.float32, False)):
        t = torch.zeros(1, 8, 2, d, dtype=dtype)
        assert pt_flash._seg_fwd_tma_ok(1, 2, t, t, t) == want
        assert pt_flash._seg_bwd_tma_ok(1, 2, 2, t, t, t, t, t) == want


def test_backward_routes_by_shape_and_alignment():
    """#2 and #4 share #4's predicate: aligned q, k, v, o and dO and
    batch x heads (query and kv) within 65535."""
    q = torch.zeros(2, 40, 6, 128, dtype=torch.bfloat16)
    kv = torch.zeros(2, 40, 2, 128, dtype=torch.bfloat16)
    assert pt_flash._seg_bwd_tma_ok(2, 6, 2, q, kv, kv, q, q)
    for i in range(5):
        ts = [q, kv, kv, q, q]
        ts[i] = _misaligned(ts[i].shape)
        assert not pt_flash._seg_bwd_tma_ok(2, 6, 2, *ts)
    assert not pt_flash._seg_bwd_tma_ok(10923, 6, 2, q, kv, kv, q, q)
    assert pt_flash._seg_bwd_tma_ok(10922, 6, 2, q, kv, kv, q, q)


@pytest.mark.parametrize("m,ffn,shift,want", [
    (1024, 704, None, True), (70, 704, None, False),
    (1024, 37, None, False), (1024, 704, "x", False),
    (1024, 704, "wd", False), (64, 128, None, True)])
def test_fused_mlp_routes_by_shape_and_alignment(m, ffn, shift, want):
    """#17 in bf16 takes its ``wgmma`` kernels where TMA maps x_send and
    the weights (M and F multiples of 8, 16-byte-aligned bases), else its
    CUDA-core kernel."""
    shapes = {"x": (64, m), "wg": (2, m, ffn), "wu": (2, m, ffn),
              "wd": (2, ffn, m)}
    ts = {k: (_misaligned(s) if k == shift
              else torch.zeros(s, dtype=torch.bfloat16))
          for k, s in shapes.items()}
    assert pt_ac._fused_tma_ok(m, ffn, *ts.values()) == want


def test_head_dim_buckets_and_refusals():
    """Every multiple of 16 in 16..256 is taken and padded to 64, 128 or
    256 (the kernels' copy is ``csrc/common.cuh``); anything else raises,
    naming the accepted set."""
    for d in range(0, 300):
        ok = 16 <= d <= 256 and d % 16 == 0
        want = 0 if not ok else 64 if d <= 64 else 128 if d <= 128 else 256
        assert _launch.head_dim_bucket(d) == want, d
        assert (d in pt_flash._HEAD_DIMS) == ok
        assert (d in pt_ragged._HEAD_DIMS) == ok
        if ok:
            pt_flash._check_head_dim("flash_attention", d)
        else:
            with pytest.raises(ValueError, match="multiple of 16 in 16..256"):
                pt_flash._check_head_dim("flash_attention", d)


def _ragged_family_smem(dp, esz):
    """``csrc/ragged.cuh``'s block over bf16 (``esz`` 2) or fp32 (4) pages:
    the page policy's ring (bf16 3 stages, fp32 2) of SK keys (K rows of
    about 8 KB, fp32 16 KB; 16 to 64 keys) of 16-byte-padded K and V rows;
    32 q rows of dp + 4 floats; 32 rows of SK + 4 softmax weights; a split's
    table entries."""
    budget, ring = {2: (8192, 3), 4: (16384, 2)}[esz]
    sk = min(64, max(16, budget // (dp * esz)))
    stage = sk * 2 * (dp * esz + 16)
    return (ring * stage + 32 * (dp + 4) * 4 + 32 * (sk + 4) * 4
            + (pt_ragged.SPLIT_KEYS + 2) * 4)


def _narrow_merge_fits(dp, esz):
    """The narrow path's merge (eight warps' m, l and accumulator rows of a
    tile of up to 8 query rows) reuses the ring, q and weight rows: it fits
    the block without the table entries."""
    merge = 8 * 8 * (dp + 4) * 4
    return merge <= _ragged_family_smem(dp, esz) - (
        pt_ragged.SPLIT_KEYS + 2) * 4


@pytest.mark.parametrize("d", [16, 96, 256])
@pytest.mark.parametrize("esz", [2, 4])
def test_ragged_smem_fits_at_every_bucket(d, esz):
    """#8's block at the padded head dim fits the H100's 227 KB, bf16 or
    fp32 pages; since the split-context family its layout depends on
    neither the GQA group nor the block size."""
    smem = pt_ragged._smem_bytes(d, esz)
    dp = _launch.head_dim_bucket(d)
    assert smem == _ragged_family_smem(dp, esz)
    assert smem <= pt_ragged._SMEM_LIMIT


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("d", [16, 96, 256])
@pytest.mark.parametrize("esz", [2, 4])
def test_paged_smem_fits_at_every_bucket(d, esz, group):
    """#9 runs #8's family (``csrc/paged_attention.cu``), so its block at
    #9's q/page pairs (bf16 or fp32 pages) is the family's layout at the
    padded head dim, fits the H100's 227 KB twice over (two blocks an SM),
    whatever the group: a decode token of a group of up to 8 is one narrow
    tile, whose merge fits the block, one of 32 a wide tile of the same
    layout."""
    dp = _launch.head_dim_bucket(d)
    smem = pt_ragged._smem_bytes(d, esz)
    assert smem == _ragged_family_smem(dp, esz)
    assert 2 * (smem + 4096) <= 233472   # two blocks with their static smem
    assert _narrow_merge_fits(dp, esz)


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("d", [16, 96, 256])
def test_quant_smem_fits_at_every_bucket(d, group):
    """#10's block at the padded head dim (one-byte pages: int8 and fp8
    alike) fits the H100's 227 KB at block 64 with a ring of four stages
    (each about 34 KB at 256), for a GQA group of 8 or 32 (four query heads
    a block at most: the group is split over blocks)."""
    dp = _launch.head_dim_bucket(d)
    stage = -(-64 * (2 * dp + 16 + 8) // 16) * 16
    heads = pt_quant.heads_per_block(72, 8 * group, 8)
    assert heads == 4
    smem = pt_quant.smem_bytes(64, d, heads, 4, 32)
    assert smem == (4 * stage + 4 * 24 + 4 * heads * 64 * 4 + heads * dp * 4
                    + 4 * 64 * 4 + 4 * heads * 16 + 32 * 4)
    assert pt_quant.ring_stages(64, d, heads, 32) == 4
    assert smem <= pt_quant._SMEM_LIMIT


@pytest.mark.parametrize("q_dtype,shape,width,block_size,partials", [
    (torch.bfloat16, (8, 32, 128), 32, 64, True),
    (torch.float32, (8, 8, 128), 32, 64, True),
    (torch.float32, (8, 32, 96), 32, 64, True),
    (torch.bfloat16, (3, 4, 256), 4, 64, False),
    (torch.float32, (3, 4, 96), 4, 8, False),
    (torch.float32, (5, 4, 64), 33, 8, True)])
def test_paged_wrapper_allocates_the_split_partials(q_dtype, shape, width,
                                                     block_size, partials):
    """#9's wrapper allocates its output through
    ``ragged_paged_attention.empty_out`` (the family's scratch), here at its
    paths' shapes (serve-eager, serve-ssm's eager step, the head-dim-96
    step) and at tables of one split and of one key past it: the fp32
    partials sit behind the output only where a table row spans several
    splits."""
    import inspect
    assert "_ragged.empty_out(q, block_tables.shape[1], block_size)" in \
        inspect.getsource(pt_paged.paged_decode_attention)
    q = torch.zeros(shape, dtype=q_dtype)
    out = pt_ragged.empty_out(q, width, block_size)
    assert out.shape == q.shape and out.dtype == q_dtype
    nsp = -(-width * block_size // pt_ragged.SPLIT_KEYS)
    assert (nsp > 1) == partials
    head = q.numel() * q.element_size()
    t, hq, d = shape
    want = (-(-head // 256) * 256 + t * hq * nsp * (d + 2) * 4
            if partials else head)
    assert out.untyped_storage().nbytes() == want
