"""The port's kernel twins against the JAX reference kernels.

Each plain PyTorch twin in ``paddle_tpu_torch.ops.kernels`` is held
against the Pallas kernel it stands for, run as the JAX tests run it on
the CPU (Pallas interpret mode), on the same numpy inputs. Tolerances
follow ``tests/op_harness.py``: fp32 rtol 1e-5 / atol 1e-6, bf16 2e-2.
The CUDA kernels themselves are held against these twins on a card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference.attention import ragged_attention_xla as jax_ragged_xla
from paddle_tpu.nn.functional import common as jax_common
from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.ops.pallas import paged_attention as jax_paged
from paddle_tpu.ops.pallas import quant as jax_quant
from paddle_tpu.ops.pallas import ragged_paged_attention as jax_ragged
from paddle_tpu.ops.pallas import rms_norm as jax_rms
from paddle_tpu.quantization import kv as jax_kvq
from paddle_tpu_torch.inference.attention import paged_attention_ragged
from paddle_tpu_torch.nn.functional import common as pt_common
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as pt_flash
from paddle_tpu_torch.ops.kernels import paged_attention as pt_paged
from paddle_tpu_torch.ops.kernels import quant as pt_quant
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as pt_ragged
from paddle_tpu_torch.ops.kernels import rms_norm as pt_rms
from paddle_tpu_torch.weights import to_torch

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    """torch or jax array -> float64 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a jax array and a torch tensor."""
    ja = jnp.asarray(a, getattr(jnp, dtype))
    return ja, to_torch(np.asarray(ja))


# ------------------------------------------------------------ ragged paged
def _ragged_inputs(q_dtype, kv_dtype, seed=0, d=128, kv=2, hq=4,
                   num_blocks=16, bs=8):
    rng = np.random.RandomState(seed)
    kc = _pair(rng.randn(num_blocks * bs, kv, d), kv_dtype)
    vc = _pair(rng.randn(num_blocks * bs, kv, d), kv_dtype)
    tables = rng.permutation(num_blocks)[:12].reshape(3, 4).astype(np.int32)
    # mixed: a decode row, a 4-token prompt chunk, a long decode, a pad
    rows = np.asarray([0, 1, 1, 1, 1, 2, 0], np.int32)
    valids = np.asarray([13, 3, 4, 5, 6, 25, 0], np.int32)
    q = _pair(rng.randn(len(rows), hq, d), q_dtype)
    return q, kc, vc, tables, rows, valids, bs


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_ragged_twin_matches_jax_kernel(q_dtype, kv_dtype):
    """Mixed prefill/decode rows with GQA and a pad row; fp32 q over bf16
    pages is the compiled step's case. The pad row is exactly 0."""
    q, kc, vc, tables, rows, valids, bs = _ragged_inputs(q_dtype, kv_dtype)
    ref = jax_ragged.ragged_paged_attention(
        q[0], kc[0], vc[0], jnp.asarray(tables), jnp.asarray(rows),
        jnp.asarray(valids), bs)
    out = pt_ragged.ragged_paged_attention_plain(
        q[1], kc[1], vc[1], torch.from_numpy(tables),
        torch.from_numpy(rows), torch.from_numpy(valids), bs)
    assert out.dtype == q[1].dtype and out.shape == q[1].shape
    tol = FP32 if q_dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    assert float(out[-1].abs().max()) == 0.0
    assert float(jnp.max(jnp.abs(ref[-1].astype(jnp.float32)))) == 0.0


def test_ragged_twin_matches_jax_composed_path():
    """Against the reference's composed ``ragged_attention_xla`` on every
    row it defines (pad rows are the caller's to drop there)."""
    q, kc, vc, tables, rows, valids, bs = _ragged_inputs("float32",
                                                         "float32", seed=1)
    ref = jax_ragged_xla(q[0], kc[0], vc[0], jnp.asarray(tables),
                         jnp.asarray(rows), jnp.asarray(valids), bs)
    out = pt_ragged.ragged_paged_attention_plain(
        q[1], kc[1], vc[1], torch.from_numpy(tables),
        torch.from_numpy(rows), torch.from_numpy(valids), bs)
    np.testing.assert_allclose(_np(out)[:-1], _np(ref)[:-1], **FP32)


def test_ragged_decode_is_special_case():
    """rows = arange, valids = seq_lens: one token per sequence."""
    q, kc, vc, tables, _, _, bs = _ragged_inputs("float32", "float32",
                                                 seed=2)
    rows = np.arange(3, dtype=np.int32)
    lens = np.asarray([13, 6, 25], np.int32)
    qd = q[1][:3]
    out = paged_attention_ragged(qd, kc[1], vc[1], tables, rows, lens, bs)
    ref = jax_ragged.ragged_paged_attention(
        q[0][:3], kc[0], vc[0], jnp.asarray(tables), jnp.asarray(rows),
        jnp.asarray(lens), bs)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)


# ------------------------------------------- ragged paged, split context
def _split_combine(q, kc, vc, tables, rows, valids, bs, split, k_scale=None,
                   v_scale=None):
    """Flash decoding in plain fp32 torch, as ``csrc/ragged.cuh`` computes
    it: each token's visible keys cut into splits of ``split`` keys at 0,
    split, 2 * split, ...; each split's row max, sum and PV partial; the
    partials merged in split order. A pad token (``valids <= 0``) is 0.
    Over one-byte pages (``k_scale``/``v_scale`` given) each element is
    dequantized first, ``k_q.float() * scale`` of its row, as the kernel's
    one-byte policies unpack it."""
    t, hq, d = q.shape
    kv = kc.shape[1]
    out = torch.zeros(t, hq, d)
    scale = 1.0 / np.sqrt(d)
    for i in range(t):
        v = int(valids[i])
        if v <= 0:
            continue
        pos = torch.arange(v)
        idx = torch.as_tensor(tables[int(rows[i])]).long()[pos // bs] * bs \
            + pos % bs
        if k_scale is None:
            k, vv = kc[idx].float(), vc[idx].float()      # v kv d
        else:   # gathered as bytes: fp8 has no CPU gather everywhere
            k = (kc.view(torch.uint8)[idx].view(kc.dtype).float()
                 * k_scale[idx].float()[..., None])
            vv = (vc.view(torch.uint8)[idx].view(vc.dtype).float()
                  * v_scale[idx].float()[..., None])
        qi = q[i].float().reshape(kv, hq // kv, d)
        parts = []
        for s0 in range(0, v, split):
            sc = torch.einsum("kgd,nkd->kgn", qi, k[s0:s0 + split]) * scale
            m = sc.max(-1).values
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgn,nkd->kgd", p, vv[s0:s0 + split])))
        big = torch.stack([m for m, _, _ in parts]).max(0).values
        num, den = torch.zeros_like(qi), torch.zeros_like(big)
        for m, l, acc in parts:
            w = torch.exp(m - big)
            den = den + w * l
            num = num + w[..., None] * acc
        out[i] = (num / den[..., None]).reshape(hq, d)
    return out.to(q.dtype)


def _split_inputs(kv_dtype, seed=5, d=64, kv=2, hq=4, bs=8):
    """Decode rows inside one split, exactly on a split boundary of the
    kernel's (``SPLIT_KEYS``), one key past it and ending inside a later
    split; a pad; a 12-token prompt-chunk run that crosses the boundary."""
    rng = np.random.RandomState(seed)
    sk = pt_ragged.SPLIT_KEYS
    width = -(-(sk + 62) // bs)
    nblocks = 5 * width
    kc = _pair(rng.randn(nblocks * bs, kv, d), kv_dtype)
    vc = _pair(rng.randn(nblocks * bs, kv, d), kv_dtype)
    tables = rng.permutation(nblocks).reshape(5, width).astype(np.int32)
    rows = np.asarray([0, 1, 2, 3, 0] + [4] * 12, np.int32)
    valids = np.asarray([13, sk, sk + 1, sk + 62, 0]
                        + list(range(sk - 8, sk + 4)), np.int32)
    q = _pair(rng.randn(len(rows), hq, d), "float32")
    return q, kc, vc, tables, rows, valids, bs


@pytest.mark.parametrize("split", [16, pt_ragged.SPLIT_KEYS])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_split_combine_matches_jax_kernel(kv_dtype, split):
    """The kernel family's arithmetic (partials per split of ``split`` keys,
    merged in split order; at the kernel's own SPLIT_KEYS and at 16, so
    that short rows split too) against the TPU kernel run as
    :func:`test_ragged_twin_matches_jax_kernel` runs it, fp32 q over fp32 or
    bf16 pages (the same page values on both sides). Tolerance FP32: the
    merge only reorders fp32 sums over at most SPLIT_KEYS + 62 keys. The
    pad is 0."""
    q, kc, vc, tables, rows, valids, bs = _split_inputs(kv_dtype)
    ref = jax_ragged.ragged_paged_attention(
        q[0], kc[0], vc[0], jnp.asarray(tables), jnp.asarray(rows),
        jnp.asarray(valids), bs)
    out = _split_combine(q[1], kc[1], vc[1], tables, rows, valids, bs, split)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    assert float(out[4].abs().max()) == 0.0


def test_split_combine_matches_port_twin():
    """The same arithmetic against the port's plain twin (one softmax over
    each row's keys), at the kernel's split size."""
    q, kc, vc, tables, rows, valids, bs = _split_inputs("float32", seed=6)
    args = (q[1], kc[1], vc[1], torch.from_numpy(tables),
            torch.from_numpy(rows), torch.from_numpy(valids), bs)
    out = _split_combine(*args, pt_ragged.SPLIT_KEYS)
    ref = pt_ragged.ragged_paged_attention_plain(*args)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)


def _quant_split_inputs(mode, seed, d=128, kv=2, hq=4, bs=8):
    """:func:`_split_inputs`'s rows (decode rows inside one split, on a
    boundary, one key past it and into a later split, a pad, a prompt chunk
    across a boundary) over one-byte pages that the JAX package quantizes
    from seeded fp32 rows, as JAX arrays and torch tensors of the same
    bytes: (q, (kq, vq, ks, vs), tables, rows, valids, bs)."""
    rng = np.random.RandomState(seed)
    sk = pt_ragged.SPLIT_KEYS
    width = -(-(sk + 62) // bs)
    nblocks = 5 * width
    pages = []
    for _ in range(2):
        jq, js = jax_kvq.quantize_kv(jnp.asarray(
            rng.randn(nblocks * bs, kv, d).astype(np.float32)), mode)
        raw = np.asarray(jq)
        if raw.dtype.name == "float8_e4m3fn":
            tq = torch.from_numpy(raw.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        else:
            tq = torch.from_numpy(raw.copy())
        pages.append(((jq, js), (tq, torch.from_numpy(np.array(js)))))
    (jk, jks), (tk, tks) = pages[0]
    (jv, jvs), (tv, tvs) = pages[1]
    tables = rng.permutation(nblocks).reshape(5, width).astype(np.int32)
    rows = np.asarray([0, 1, 2, 3, 0] + [4] * 12, np.int32)
    valids = np.asarray([13, sk, sk + 1, sk + 62, 0]
                        + list(range(sk - 8, sk + 4)), np.int32)
    q = _pair(rng.randn(len(rows), hq, d), "float32")
    return q, ((jk, jv, jks, jvs), (tk, tv, tks, tvs)), tables, rows, \
        valids, bs


@pytest.mark.parametrize("split", [16, pt_ragged.SPLIT_KEYS])
def test_split_combine_over_int8_pages_matches_jax_kernel(split):
    """The split-context arithmetic over int8 pages, each element
    dequantized first and then the fp32 products (partials per split of
    ``split`` keys, merged in split order; the family's arithmetic were it
    to run #10), against the TPU kernel of #10
    (``paddle_tpu/ops/pallas/quant.py``, interpret mode on the CPU) at head
    dim 128, on the same page bytes and scales. Tolerance FP32: only the
    order of fp32 sums differs. The pad is 0."""
    q, (jp, tp), tables, rows, valids, bs = _quant_split_inputs("int8", 11)
    assert jax_quant.eligible(q[0].shape, 2, 128, jp[0].dtype)
    ref = jax_quant.ragged_paged_attention_quant(
        q[0], *jp, jnp.asarray(tables), jnp.asarray(rows),
        jnp.asarray(valids), bs)
    tk, tv, tks, tvs = tp
    out = _split_combine(q[1], tk, tv, tables, rows, valids, bs, split,
                         tks, tvs)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    assert float(out[4].abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_split_combine_over_quantized_pages_matches_port_twin(mode):
    """The same arithmetic against #10's plain twin (dequantize, one
    softmax over each row's keys), int8 and fp8 e4m3 pages, at the kernel's
    split size."""
    q, (_, tp), tables, rows, valids, bs = _quant_split_inputs(mode, 12)
    tk, tv, tks, tvs = tp
    idx = (torch.from_numpy(tables), torch.from_numpy(rows),
           torch.from_numpy(valids))
    ref = pt_quant.ragged_paged_attention_quant_plain(q[1], tk, tv, tks, tvs,
                                                      *idx, bs)
    out = _split_combine(q[1], tk, tv, tables, rows, valids, bs,
                         pt_ragged.SPLIT_KEYS, tks, tvs)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)


@pytest.mark.parametrize("split", [16, pt_ragged.SPLIT_KEYS])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_paged_decode_is_the_split_family_decode_case(kv_dtype, split):
    """#9 as the family computes it (``csrc/paged_attention.cu``): rows
    ``0..b-1``, valids the sequence lengths, every token a tile of its own,
    against the TPU kernel of #9 (``paddle_tpu/ops/pallas/paged_attention.py``,
    interpret mode) over fp32 and bf16 pages, with lengths inside one split,
    on a split boundary, past it, and 0 (exactly 0 out)."""
    rng = np.random.RandomState(13)
    sk, bs, d = pt_ragged.SPLIT_KEYS, 8, 128
    lens = np.asarray([13, sk, 0, sk + 40], np.int32)
    width = -(-(sk + 40) // bs)
    nblocks = len(lens) * width + 1
    kc = _pair(rng.randn(nblocks * bs, 2, d), kv_dtype)
    vc = _pair(rng.randn(nblocks * bs, 2, d), kv_dtype)
    q = _pair(rng.randn(len(lens), 4, d), "float32")
    tables = (1 + rng.permutation(nblocks - 1)).reshape(
        len(lens), width).astype(np.int32)
    assert jax_paged.eligible(q[0].shape, 2, d)
    ref = jax_paged.paged_decode_attention(q[0], kc[0], vc[0],
                                           jnp.asarray(tables), lens, bs)
    out = _split_combine(q[1], kc[1], vc[1], tables,
                         np.arange(len(lens), dtype=np.int32), lens, bs,
                         split)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    assert float(out[2].abs().max()) == 0.0
    twin = pt_paged.paged_decode_attention(
        q[1], kc[1], vc[1], torch.from_numpy(tables),
        torch.from_numpy(lens), bs)
    np.testing.assert_allclose(_np(out), _np(twin), **FP32)


def test_split_constants_mirror_the_kernel_header():
    """``SPLIT_KEYS`` and the shared-memory mirror read the numbers
    ``csrc/ragged.cuh`` is built with: the split size, the tile rows, each
    page policy's element bytes, stage bytes and ring depth (bf16 and
    fp32), and the stage keys they give at each padded head dim."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(pt_ragged.__file__), "..", "..",
                            "csrc", "ragged.cuh")).read()
    const = dict(re.findall(r"^constexpr int (k\w+) = (\d+);", src, re.M))
    assert int(const["kSplitKeys"]) == pt_ragged.SPLIT_KEYS
    assert int(const["kTileRows"]) == pt_ragged._TILE_ROWS
    policies = {}
    for name, body in re.findall(r"struct (Page\w+) \{(.*?)\n\};", src,
                                 re.S):
        vals = dict(re.findall(r"static constexpr int (k\w+) = (\d+);", body))
        policies[name] = (int(vals["kBytes"]), int(vals["kStageBytes"]),
                          int(vals["kRing"]))
    assert set(policies) == {"PageBF16", "PageF32"}
    for esz, stage, ring in policies.values():
        assert pt_ragged.PAGE_GEOMETRY[esz] == (stage, ring)
    assert "kSkRaw = P::kStageBytes / kRowBytes" in src
    keys = {(d, e): pt_ragged._stage_keys(d, e)
            for d in (64, 128, 256) for e in (2, 4)}
    assert keys == {(64, 2): 64, (128, 2): 32, (256, 2): 16,
                    (64, 4): 64, (128, 4): 32, (256, 4): 16}


@pytest.mark.parametrize("width,block_size,partials", [
    (4, 64, False), (32, 8, False), (33, 8, True), (32, 64, True)])
def test_empty_out_holds_the_split_partials(width, block_size, partials):
    """The wrapper's output is q-shaped and contiguous; where a table row
    spans several splits, its allocation holds the fp32 partials behind it
    (256-byte aligned): ``[t, hq, nsp, d]`` accumulators and ``[t, hq,
    nsp]`` (m, l) pairs."""
    q = torch.zeros(5, 4, 64, dtype=torch.bfloat16)
    out = pt_ragged.empty_out(q, width, block_size)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.is_contiguous()
    nbytes = out.untyped_storage().nbytes()
    nsp = -(-width * block_size // pt_ragged.SPLIT_KEYS)
    assert (nsp > 1) == partials
    if partials:
        head = -(-q.numel() * 2 // 256) * 256
        assert nbytes == head + 5 * 4 * nsp * (64 + 2) * 4
    else:
        assert nbytes == q.numel() * 2


# --------------------------------------------------------- flash attention
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(40, 40), (24, 40)])
def test_flash_twin_matches_jax_kernel(causal, sq, sk):
    """GQA 4:2, lengths that are not block multiples (16-row blocks), O and
    the log-sum-exp; causal masks are top-left aligned."""
    rng = np.random.RandomState(3)
    q = _pair(rng.randn(2, sq, 4, 128), "float32")
    k = _pair(rng.randn(2, sk, 2, 128), "float32")
    v = _pair(rng.randn(2, sk, 2, 128), "float32")
    ref_o, ref_lse = jax_flash.flash_attention_with_lse(
        q[0], k[0], v[0], is_causal=causal, block_q=16, block_k=16)
    o, lse = pt_flash.flash_attention_plain(q[1], k[1], v[1], causal)
    assert o.shape == q[1].shape and lse.shape == (2, 4, sq)
    np.testing.assert_allclose(_np(o), _np(ref_o), **FP32)
    np.testing.assert_allclose(_np(lse), _np(ref_lse), **FP32)


def test_flash_twin_matches_jax_kernel_bf16():
    """bf16 inputs: fp32 scores from exact products, p rounded to bf16
    before the PV product; output bf16."""
    rng = np.random.RandomState(4)
    q = _pair(rng.randn(1, 33, 4, 128), "bfloat16")
    k = _pair(rng.randn(1, 33, 1, 128), "bfloat16")
    v = _pair(rng.randn(1, 33, 1, 128), "bfloat16")
    ref_o, ref_lse = jax_flash.flash_attention_with_lse(
        q[0], k[0], v[0], is_causal=True, block_q=16, block_k=16)
    o, lse = pt_flash.flash_attention_with_lse(q[1], k[1], v[1], True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(o), _np(ref_o), **BF16)
    np.testing.assert_allclose(_np(lse), _np(ref_lse), **FP32)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_sdpa_math_matches_jax(causal, masked):
    """The composed attention core (``_sdpa_math``) against the reference's
    on GQA inputs, with a boolean mask or the causal mask; the flash
    twin's O agrees with it."""
    rng = np.random.RandomState(8)
    q = _pair(rng.randn(2, 9, 4, 64), "float32")
    k = _pair(rng.randn(2, 9, 2, 64), "float32")
    v = _pair(rng.randn(2, 9, 2, 64), "float32")
    jmask = tmask = None
    if masked:
        mask = rng.rand(9, 9) > 0.3
        np.fill_diagonal(mask, True)
        jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    ref = jax_common._sdpa_math(q[0], k[0], v[0], jmask, is_causal=causal)
    out = pt_common._sdpa_math(q[1], k[1], v[1], tmask, is_causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    if not masked:
        o, _ = pt_flash.flash_attention_plain(q[1], k[1], v[1], causal)
        np.testing.assert_allclose(_np(o), _np(out), **FP32)


# ----------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_rms_norm_twin_matches_jax_kernel(x_dtype):
    """A width that is no multiple of 128 (the TPU kernel pads to the
    lane boundary and divides by the true width) and an fp32 weight; the
    output keeps x's dtype."""
    rng = np.random.RandomState(5)
    x = _pair(rng.randn(3, 7, 200) * 3.0, x_dtype)
    w = _pair(1.0 + 0.1 * rng.randn(200), "float32")
    ref = jax_rms.rms_norm(x[0], w[0], 1e-6)
    out = pt_rms.rms_norm(x[1], w[1], 1e-6)
    assert out.dtype == x[1].dtype and ref.dtype == x[0].dtype
    np.testing.assert_allclose(_np(out), _np(ref),
                               **(FP32 if x_dtype == "float32" else BF16))


def test_cpu_wrappers_take_the_twin_and_count_no_launch():
    """On CPU tensors a wrapper runs its plain twin; only a kernel launch
    counts."""
    kernels.reset_launch_counts()
    x = torch.randn(4, 64)
    assert torch.equal(pt_rms.rms_norm(x, torch.ones(64)),
                       pt_rms.rms_norm_plain(x, torch.ones(64)))
    q = torch.randn(1, 8, 2, 64)
    o = pt_flash.flash_attention(q, q[:, :, :1], q[:, :, :1], True)
    assert torch.equal(o, pt_flash.flash_attention_plain(
        q, q[:, :, :1], q[:, :, :1], True)[0])
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}
