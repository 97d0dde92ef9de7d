"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

These tests need a card and skip without one (the kernels have no CPU
mode). The file imports only torch and the port, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances follow ``tests/op_harness.py`` (fp32 rtol 1e-5 / atol 1e-6,
bf16 2e-2); the log-sum-exp is held at atol 1e-5 because it adds a log
of an fp32 row sum taken in another order. fp32 matmuls in the twins run
without TF32.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import functional as pt_inc
from paddle_tpu_torch.ops.kernels import flash_attention as pt_flash
from paddle_tpu_torch.ops.kernels import fused_block as pt_fb
from paddle_tpu_torch.ops.kernels import grouped_gemm as pt_gg
from paddle_tpu_torch.ops.kernels import paged_attention as pt_paged
from paddle_tpu_torch.ops.kernels import quant as pt_quant
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as pt_ragged
from paddle_tpu_torch.ops.kernels import rms_norm as pt_rms
from paddle_tpu_torch.ops.kernels import selective_scan as pt_ss

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return x.detach().float().cpu().numpy().astype(np.float64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ragged_inputs(dev, q_dtype, kv_dtype, d=128, kv=2, hq=4, num_blocks=16,
                   bs=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    kc = torch.randn(num_blocks * bs, kv, d, generator=g)
    vc = torch.randn(num_blocks * bs, kv, d, generator=g)
    tables = torch.randperm(num_blocks, generator=g)[:12].reshape(3, 4)
    rows = torch.tensor([0, 1, 1, 1, 1, 2, 0])
    valids = torch.tensor([13, 3, 4, 5, 6, 25, 0])
    q = torch.randn(len(rows), hq, d, generator=g)
    kvt, qt = getattr(torch, kv_dtype), getattr(torch, q_dtype)
    return [q.to(dev, qt), kc.to(dev, kvt), vc.to(dev, kvt),
            tables.to(dev, torch.int32), rows.to(dev, torch.int32),
            valids.to(dev, torch.int32), bs]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_ragged_kernel_matches_twin(cuda_device, q_dtype, kv_dtype):
    args = _ragged_inputs(cuda_device, q_dtype, kv_dtype)
    out = pt_ragged.ragged_paged_attention(*args)
    ref = pt_ragged.ragged_paged_attention_plain(*args)
    torch.cuda.synchronize()
    tol = FP32 if q_dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    assert float(out[-1].abs().max()) == 0.0


# #8 across its context splits (csrc/ragged.cuh: splits of SPLIT_KEYS keys
# at fixed positions, partials merged by a second launch), and #10 at the
# same lengths: decode rows inside one split, exactly on a boundary, one key
# past it and over many (up to 2048 keys), a prompt-chunk run crossing a
# boundary, pads
_SPLIT_LENS = [1, 255, 256, 257, 511, 512, 513, 2048]
_SPLIT_CHUNK = list(range(241, 265))


def _split_inputs(dev, bs, group, pages, q_dtype, d=64, hkv=2, seed=0):
    """Decode rows at ``_SPLIT_LENS``, a pad, the chunk run on a row of its
    own, two pads; every table row 2048 keys of shuffled blocks. ``pages``
    is a torch dtype name, or ``int8``/``fp8`` for quantized pages (then
    the scales follow the pages in the argument list)."""
    from paddle_tpu_torch.quantization import kv as kvq
    g = torch.Generator().manual_seed(seed + 7 * bs + group)
    width = 2048 // bs
    nrows = len(_SPLIT_LENS) + 1
    tables = torch.randperm(nrows * width, generator=g).reshape(nrows, width)
    rows = list(range(len(_SPLIT_LENS))) + [0] \
        + [nrows - 1] * len(_SPLIT_CHUNK) + [0, 0]
    valids = _SPLIT_LENS + [0] + _SPLIT_CHUNK + [0, 0]
    k = torch.randn(nrows * width * bs, hkv, d, generator=g)
    v = torch.randn(nrows * width * bs, hkv, d, generator=g)
    q = torch.randn(len(rows), hkv * group, d, generator=g).to(
        dev, getattr(torch, q_dtype))
    if pages in ("int8", "fp8"):
        kq, ks = kvq.quantize_kv(k.to(dev), pages)
        vq, vs = kvq.quantize_kv(v.to(dev), pages)
        cache = [kq, vq, ks, vs]
    else:
        cache = [k.to(dev, getattr(torch, pages)),
                 v.to(dev, getattr(torch, pages))]
    return [q, *cache, tables.to(dev, torch.int32),
            torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(valids, dtype=torch.int32, device=dev), bs], valids


def _check_split_call(mod, fn, plain, args, valids, tol):
    """Two launches bitwise equal, one launch count a call, pads exactly 0,
    the output within ``tol`` of the twin: a number is an absolute bound,
    ``"max"`` 1e-4 x the twin's largest magnitude, ``"bf16"`` the bf16
    tier."""
    mod.launches = 0
    out = fn(*args)
    again = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert mod.launches == 2
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert torch.equal(out, again)
    err = np.abs(_np(out) - _np(ref)).max()
    if tol == "bf16":
        np.testing.assert_allclose(_np(out), _np(ref), **BF16)
    elif tol == "max":
        assert err <= 1e-4 * np.abs(_np(ref)).max(), err
    else:
        assert err <= tol, err
    pads = [i for i, x in enumerate(valids) if x == 0]
    assert float(out[pads].abs().max()) == 0.0
    return out


def _repeat_and_twin(mod, fn, plain, args, tol):
    """Two launches bitwise equal (one launch count a call) and the output
    within ``tol`` of the twin (an absolute bound or ``"bf16"``)."""
    mod.launches = 0
    out = fn(*args)
    again = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert mod.launches == 2 and torch.equal(out, again)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    if tol == "bf16":
        np.testing.assert_allclose(_np(out), _np(ref), **BF16)
    else:
        assert np.abs(_np(out) - _np(ref)).max() <= tol
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_ragged_kernel_across_splits(cuda_device, bs, group):
    """#8, fp32 q over bf16 pages (the compiled step's pair), against its
    twin to 2e-5: fp32 sums over up to 2048 keys, merged over splits, in
    another order than the twin's softmax."""
    args, valids = _split_inputs(cuda_device, bs, group, "bfloat16",
                                 "float32")
    _check_split_call(pt_ragged, pt_ragged.ragged_paged_attention,
                      pt_ragged.ragged_paged_attention_plain, args, valids,
                      2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,group", [
    ("float32", "float32", 4), ("bfloat16", "bfloat16", 4),
    ("float32", "bfloat16", 16), ("float32", "bfloat16", 32)])
def test_ragged_kernel_across_splits_dtypes(cuda_device, q_dtype, kv_dtype,
                                            group):
    """#8's other dtype pairs at head dim 128, and groups of 16 and 32
    (decode rows on the register-tiled path) across the splits."""
    args, valids = _split_inputs(cuda_device, 16, group, kv_dtype, q_dtype,
                                 d=128)
    _check_split_call(pt_ragged, pt_ragged.ragged_paged_attention,
                      pt_ragged.ragged_paged_attention_plain, args, valids,
                      2e-5 if q_dtype == "float32" else "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("bs", [8, 16, 64])
def test_quant_kernel_across_splits(cuda_device, bs, group):
    """#10 over int8 pages with an fp32 q against its twin to 1e-4 x the
    twin's largest magnitude (the scales fold into scores and weights in
    the kernel, into the pages in the twin)."""
    args, valids = _split_inputs(cuda_device, bs, group, "int8", "float32")
    _check_split_call(pt_quant, pt_quant.ragged_paged_attention_quant,
                      pt_quant.ragged_paged_attention_quant_plain, args,
                      valids, "max")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,q_dtype", [("fp8", "float32"),
                                          ("int8", "bfloat16"),
                                          ("fp8", "bfloat16")])
def test_quant_kernel_across_splits_dtypes(cuda_device, mode, q_dtype):
    """#10 over fp8 pages and with a bf16 q, head dim 128, across the
    splits."""
    args, valids = _split_inputs(cuda_device, 16, 4, mode, q_dtype, d=128)
    _check_split_call(pt_quant, pt_quant.ragged_paged_attention_quant,
                      pt_quant.ragged_paged_attention_quant_plain, args,
                      valids, "max" if q_dtype == "float32" else "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bfloat16", "float32", "int8", "fp8"])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_ragged_decode_rows_alone_are_bitwise(cuda_device, pages, group):
    """A decode row's bits depend only on its own q, pages and valids: each
    decode row computed alone (T = 1) equals its row of the full call,
    whatever its splits, for #8 and #10."""
    args, valids = _split_inputs(cuda_device, 64, group, pages, "float32")
    quant = pages in ("int8", "fp8")
    mod = pt_quant if quant else pt_ragged
    fn = pt_quant.ragged_paged_attention_quant if quant \
        else pt_ragged.ragged_paged_attention
    full = fn(*args)
    q, rows, vals = args[0], args[-3], args[-2]
    for i in range(len(_SPLIT_LENS)):
        alone = fn(q[i:i + 1].contiguous(), *args[1:-3],
                   rows[i:i + 1].contiguous(), vals[i:i + 1].contiguous(),
                   args[-1])
        assert torch.equal(alone[0], full[i]), (i, valids[i])
    assert mod.launches > 0


# the paged attention kernels at every head dim the wrappers take: #8 (fp32 q
# over bf16 or fp32 pages) and #9 (its three q/page pairs) on the
# split-context family, and #10 (int8 or fp8 pages, fp32 or bf16 q)
_FAMILY_CASES = [("ragged", "float32", "bfloat16"), ("ragged", "float32", "float32"),
                 ("paged", "float32", "bfloat16"), ("paged", "float32", "float32"),
                 ("paged", "bfloat16", "bfloat16"), ("quant", "float32", "int8"),
                 ("quant", "bfloat16", "int8"), ("quant", "float32", "fp8"),
                 ("quant", "bfloat16", "fp8")]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,q_dtype,pages", _FAMILY_CASES)
@pytest.mark.parametrize("d", list(range(16, 257, 16)))
def test_family_kernels_at_every_head_dim(cuda_device, d, kernel, q_dtype,
                                          pages):
    """#8 and #9 (``csrc/ragged.cuh``) and #10 at every multiple of 16 up to
    256 (built at 64, 128 or 256, the columns past d masked), GQA 4:2, rows
    across the split boundaries: two launches bitwise equal, pads exactly 0,
    against the twin (fp32 2e-5 for #8 and #9, 1e-4 x max|twin| for #10,
    the bf16 tier for a bf16 q), and every decode row alone equal to its
    row of the full call."""
    args, valids = _split_inputs(cuda_device, 16, 2, pages, q_dtype, d=d)
    fp32 = q_dtype == "float32"
    if kernel == "paged":   # the decode rows: sequence i reads table row i
        n = len(_SPLIT_LENS)
        q, tables = args[0][:n].contiguous(), args[-4][:n].contiguous()
        lens = args[-2][:n].contiguous()
        args = [q, args[1], args[2], tables, lens, args[-1]]
        out = _repeat_and_twin(pt_paged, pt_paged.paged_decode_attention,
                               pt_paged.paged_decode_attention_plain, args,
                               2e-5 if fp32 else "bf16")
        for i in range(n):
            alone = pt_paged.paged_decode_attention(
                q[i:i + 1].contiguous(), args[1], args[2],
                tables[i:i + 1].contiguous(), lens[i:i + 1].contiguous(),
                args[-1])
            assert torch.equal(alone[0], out[i]), (d, i)
        return
    mod = pt_quant if kernel == "quant" else pt_ragged
    fn = pt_quant.ragged_paged_attention_quant if kernel == "quant" \
        else pt_ragged.ragged_paged_attention
    plain = pt_quant.ragged_paged_attention_quant_plain if kernel == "quant" \
        else pt_ragged.ragged_paged_attention_plain
    tol = ("max" if kernel == "quant" else 2e-5) if fp32 else "bf16"
    out = _check_split_call(mod, fn, plain, args, valids, tol)
    q, rows, vals = args[0], args[-3], args[-2]
    for i in range(len(_SPLIT_LENS)):
        alone = fn(q[i:i + 1].contiguous(), *args[1:-3],
                   rows[i:i + 1].contiguous(), vals[i:i + 1].contiguous(),
                   args[-1])
        assert torch.equal(alone[0], out[i]), (d, i)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [("float32", "bfloat16"),
                                  ("float32", "float32"),
                                  ("bfloat16", "bfloat16")])
def test_paged_decode_rows_are_the_ragged_rows(cuda_device, pair):
    """#9 is #8's decode case on the same family: each sequence's output
    equals, bit for bit, #8's output for the same token (rows = arange,
    valids = seq_lens), whatever its splits."""
    q_dtype, kv_dtype = pair
    args, valids = _split_inputs(cuda_device, 64, 4, kv_dtype, q_dtype)
    n = len(_SPLIT_LENS)
    q, tables = args[0][:n].contiguous(), args[-4][:n].contiguous()
    lens = args[-2][:n].contiguous()
    paged = pt_paged.paged_decode_attention(q, args[1], args[2], tables, lens,
                                            args[-1])
    ragged = pt_ragged.ragged_paged_attention(
        q, args[1], args[2], tables,
        torch.arange(n, dtype=torch.int32, device=cuda_device), lens,
        args[-1])
    torch.cuda.synchronize()
    assert torch.equal(paged, ragged)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["eager", "ssm"])
def test_paged_decode_kernel_at_path_shapes(cuda_device, path):
    """#9 at its two paths' shapes: serve-eager's step (bf16 q [8, 32,
    128] over bf16 pages, kv 8, block 64, lengths 64..1056) and serve-ssm's
    eager step (fp32 q [8, 8, 128] over fp32 pages, lengths 1023..1055),
    against the twin (bf16: 2e-2 of each sequence's max|twin|; fp32 2e-5),
    bitwise on repeat."""
    g = torch.Generator().manual_seed(82)
    hq, dtype, lens = ((32, torch.bfloat16, [64 + 142 * i for i in range(7)]
                        + [1056]) if path == "eager" else
                       (8, torch.float32, [1023 + 32 * i // 7
                                           for i in range(8)]))
    bs, width, hkv, d = 64, 32, 8, 128
    nb = 8 * width
    kc = torch.randn(nb * bs, hkv, d, generator=g).to(cuda_device, dtype)
    vc = torch.randn(nb * bs, hkv, d, generator=g).to(cuda_device, dtype)
    tables = torch.randperm(nb, generator=g).reshape(8, width)
    q = torch.randn(8, hq, d, generator=g).to(cuda_device, dtype)
    args = [q, kc, vc, tables.to(cuda_device, torch.int32),
            torch.tensor(lens, dtype=torch.int32, device=cuda_device), bs]
    pt_paged.launches = 0
    out = pt_paged.paged_decode_attention(*args)
    again = pt_paged.paged_decode_attention(*args)
    ref = pt_paged.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert pt_paged.launches == 2 and torch.equal(out, again)
    if dtype == torch.float32:
        assert np.abs(_np(out) - _np(ref)).max() <= 2e-5
    else:
        for o, r in zip(_np(out), _np(ref)):
            assert np.abs(o - r).max() <= 2e-2 * np.abs(r).max()


# #8 at phase_ragged's shapes (chip_smoke.py): (a) its timing shape, (b) the
# serve decode step, (c) a fleet decode step, (d) serve-ssm's fp32 step
_SERVE_DECODE_LENS = [48, 190, 332, 473, 615, 757, 899, 1040]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["a", "b", "c", "d"])
def test_ragged_kernel_at_smoke_shapes(cuda_device, case):
    """#8 at the four shapes ``chip_smoke.py`` times, against its twin to
    2e-5, bitwise on repeat, pads exactly 0, every decode row alone equal
    to its row."""
    rows, valids, seqs, hq, kv_dtype = {
        "a": (_RAGGED_ROWS, _RAGGED_VALIDS, 8, 32, torch.bfloat16),
        "b": (list(range(8)), _SERVE_DECODE_LENS, 8, 32, torch.bfloat16),
        "c": ([0] * 8, [1040] + [0] * 7, 1, 32, torch.bfloat16),
        "d": (list(range(8)), [1040] * 8, 8, 8, torch.float32)}[case]
    g = torch.Generator().manual_seed(83)
    bs, width, hkv, d = 64, 32, 8, 128
    tables = torch.randperm(seqs * width, generator=g).reshape(seqs, width)
    kc = torch.randn(seqs * width * bs, hkv, d, generator=g).to(cuda_device,
                                                               kv_dtype)
    vc = torch.randn(seqs * width * bs, hkv, d, generator=g).to(cuda_device,
                                                               kv_dtype)
    q = torch.randn(len(rows), hq, d, generator=g).to(cuda_device)
    args = [q, kc, vc, tables.to(cuda_device, torch.int32),
            torch.tensor(rows, dtype=torch.int32, device=cuda_device),
            torch.tensor(valids, dtype=torch.int32, device=cuda_device), bs]
    out = _repeat_and_twin(pt_ragged, pt_ragged.ragged_paged_attention,
                           pt_ragged.ragged_paged_attention_plain, args, 2e-5)
    pads = [i for i, x in enumerate(valids) if x == 0]
    assert not pads or float(out[pads].abs().max()) == 0.0
    for i, v in enumerate(valids):
        if v <= 0 or any(0 <= j < len(rows) and valids[j] > 0
                         and rows[j] == rows[i] for j in (i - 1, i + 1)):
            continue
        alone = pt_ragged.ragged_paged_attention(
            q[i:i + 1].contiguous(), kc, vc, args[3], args[4][i:i + 1],
            args[5][i:i + 1], bs)
        assert torch.equal(alone[0], out[i]), (case, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_twin(cuda_device, dtype, causal):
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, s, h, 128).astype(np.float32))
               .to(cuda_device, getattr(torch, dtype))
               for s, h in ((100, 4), (130, 2), (130, 2)))
    o, lse = pt_flash.flash_attention_with_lse(q, k, v, causal)
    ro, rlse = pt_flash.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("sq,sk", [(100, 130), (1000, 1000), (130, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_kernel_matches_twin(cuda_device, d, causal, sq, sk,
                                         group):
    """The bf16 forward (wgmma over a TMA ring) at both head dims, causal
    and full, lengths no tile divides with Sq != Sk both ways, GQA 1:1 to
    4:1; a second launch bitwise."""
    rng = np.random.RandomState(sq + 7 * d + group)
    q, k, v = (torch.from_numpy(rng.randn(2, s, h, d).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for s, h in ((sq, 4), (sk, 4 // group), (sk, 4 // group)))
    o, lse = pt_flash.flash_attention_with_lse(q, k, v, causal)
    o2, lse2 = pt_flash.flash_attention_with_lse(q, k, v, causal)
    ro, rlse = pt_flash.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(o), _np(ro), **BF16)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5, atol=1e-5)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_matches_twin(cuda_device, dtype):
    x = torch.randn(33, 200, device=cuda_device).to(getattr(torch, dtype))
    w = torch.rand(200, device=cuda_device) + 0.5
    out = pt_rms.rms_norm(x, w)
    ref = pt_rms.rms_norm_plain(x, w)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)


def _rand(dev, dtype, *shape, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(dev,
                                                        getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk", [(True, 130, 130), (False, 100, 130)])
def test_flash_backward_kernel_matches_twin(cuda_device, dtype, causal, sq,
                                            sk):
    """dQ, dK, dV with GQA 4:2 and ragged lengths; a second launch on
    the same inputs gives the same bits (no atomics). Gradients are sums
    over up to 130 keys or 2x130 queries: atol scaled by each tensor's
    largest magnitude."""
    q = _rand(cuda_device, dtype, 2, sq, 4, 128, seed=1)
    k = _rand(cuda_device, dtype, 2, sk, 2, 128, seed=2)
    v = _rand(cuda_device, dtype, 2, sk, 2, 128, seed=3)
    do = _rand(cuda_device, dtype, 2, sq, 4, 128, seed=4)
    o, lse = pt_flash.flash_attention_with_lse(q, k, v, causal)
    got = pt_flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = pt_flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = pt_flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        ref = _np(c)
        np.testing.assert_allclose(_np(a), ref, rtol=tol["rtol"],
                                   atol=tol["atol"] * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 3, 4])
@pytest.mark.parametrize("sq,sk", [(100, 130), (1000, 1000), (130, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_wgmma_kernel_matches_twin(cuda_device, d, causal, sq,
                                                  sk, group):
    """The bf16 backward (dQ and delta, then dK/dV, on wgmma over TMA
    rings) at both head dims, causal and full, lengths no tile divides
    with Sq != Sk both ways, GQA 1:1 to 4:1 over two kv heads; the bf16
    tier with atol scaled by each gradient's largest magnitude, and a
    second launch bitwise."""
    hkv = 2
    q = _rand(cuda_device, "bfloat16", 2, sq, group * hkv, d, seed=sq + d)
    k = _rand(cuda_device, "bfloat16", 2, sk, hkv, d, seed=sk + 1)
    v = _rand(cuda_device, "bfloat16", 2, sk, hkv, d, seed=sk + 2)
    do = _rand(cuda_device, "bfloat16", 2, sq, group * hkv, d, seed=group)
    o, lse = pt_flash.flash_attention_with_lse(q, k, v, causal)
    got = pt_flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = pt_flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = pt_flash.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == c.shape
        assert torch.equal(a, b)
        ref = _np(c)
        np.testing.assert_allclose(_np(a), ref, rtol=BF16["rtol"],
                                   atol=BF16["atol"] * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_backward_kernel_matches_twin(cuda_device, dtype):
    """dx and the cross-row dw (fp32 atol 1e-5: 77 rows summed in
    another order) at width 200, a warp a row; bitwise repeat (the widths
    off the vector are in test_rms_norm_backward_routes_match_twin)."""
    x = _rand(cuda_device, dtype, 77, 200, scale=3.0, seed=5)
    dy = _rand(cuda_device, dtype, 77, 200, seed=6)
    w = torch.rand(200, device=cuda_device) + 0.5
    dx, dw = pt_rms.rms_norm_bwd(x, w, dy)
    dx2, dw2 = pt_rms.rms_norm_bwd(x, w, dy)
    rdx, rdw = pt_rms.rms_norm_bwd_plain(x, w, dy)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(dx), _np(rdx), **tol)
    np.testing.assert_allclose(_np(dw), _np(rdw), rtol=1e-5,
                               atol=1e-5 if dtype == "float32" else 1e-3)


def _rms_inputs(dev, dtype, rows, d, misaligned=False, seed=0):
    """x and dy [rows, d] (one element past a 16-byte boundary when
    ``misaligned``: the general route) and an fp32 weight."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for scale in (3.0, 1.0):
        t = (torch.randn(rows * d + 8, generator=g) * scale).to(
            dev, getattr(torch, dtype))
        off = int(misaligned)
        t = t[off:off + rows * d].view(rows, d)
        assert (t.data_ptr() % 16 != 0) == misaligned
        out.append(t)
    w = (torch.rand(d, generator=g) + 0.5).to(dev)
    return out[0], out[1], w


# 202 and 1001 are no multiple of the 16-byte vector at either dtype (the
# general route, dw summed as floats); bf16 100 is no multiple of 8 (the
# general route, dw summed as float4s)
_RMS_WIDTHS = [100, 200, 202, 1001, 1024, 1536, 4096, 8192]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 7, 8192])
@pytest.mark.parametrize("d", _RMS_WIDTHS)
def test_rms_norm_routes_match_twin(cuda_device, d, rows, dtype):
    """#5 against its twin at every width of the paths and 1, 7 and 8192
    rows: up to 1536 a warp a row, 4096 and 8192 a warpgroup a row, except
    the general route's widths: fp32 8192 (vectorised), bf16 100, and 202
    and 1001 at either dtype (scalar: no multiple of the vector)."""
    x, _, w = _rms_inputs(cuda_device, dtype, rows, d)
    out = pt_rms.rms_norm(x, w, 1e-5)
    ref = pt_rms.rms_norm_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_allclose(_np(out), _np(ref),
                               **(FP32 if dtype == "float32" else BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 7, 8192])
@pytest.mark.parametrize("d", _RMS_WIDTHS)
def test_rms_norm_backward_routes_match_twin(cuda_device, d, rows, dtype):
    """#6 against its twin at the same widths and rows (the general route's
    dw summed as floats at 202 and 1001, as float4s elsewhere): dx at its
    dtype's tier, dw (fp32 sums over the rows in another order) to 1e-5 of
    its largest magnitude; dw and dx the same bits on a second launch."""
    x, dy, w = _rms_inputs(cuda_device, dtype, rows, d, seed=1)
    dx, dw = pt_rms.rms_norm_bwd(x, w, dy, 1e-5)
    dx2, dw2 = pt_rms.rms_norm_bwd(x, w, dy, 1e-5)
    rdx, rdw = pt_rms.rms_norm_bwd_plain(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.dtype == x.dtype and dw.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), _np(rdx),
                               **(FP32 if dtype == "float32" else BF16))
    top = np.abs(_np(rdw)).max()
    np.testing.assert_allclose(_np(dw), _np(rdw), rtol=1e-4, atol=1e-5 * top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1024, 4096])
def test_rms_norm_misaligned_base_takes_the_general_route(cuda_device, d,
                                                          dtype):
    """x and dy one element off a 16-byte boundary: both kernels take
    their general route, against the twins, dw bitwise on repeat."""
    x, dy, w = _rms_inputs(cuda_device, dtype, 77, d, misaligned=True,
                           seed=2)
    out = pt_rms.rms_norm(x, w)
    dx, dw = pt_rms.rms_norm_bwd(x, w, dy)
    dw2 = pt_rms.rms_norm_bwd(x, w, dy)[1]
    ref = pt_rms.rms_norm_plain(x, w)
    rdx, rdw = pt_rms.rms_norm_bwd_plain(x, w, dy)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    np.testing.assert_allclose(_np(dx), _np(rdx), **tol)
    np.testing.assert_allclose(_np(dw), _np(rdw), rtol=1e-4,
                               atol=1e-5 * np.abs(_np(rdw)).max())
    assert torch.equal(dw, dw2)


@pytest.mark.cuda
def test_rms_norm_backward_reuses_its_partials(cuda_device):
    """The backward's partial rows are kept for the stream and the row
    width and reused by calls of other row counts; a width of its own gets
    a buffer of its own, and no buffer is ever replaced (a captured graph
    keeps its address): each call equals a fresh twin, and a repeat after
    the others gives the first call's bits through the first buffer."""
    from paddle_tpu_torch.ops.kernels import _launch
    first = None
    for rows, d in ((8192, 1536), (7, 1536), (1, 1024), (3000, 4096),
                    (8192, 1536)):
        x, dy, w = _rms_inputs(cuda_device, "bfloat16", rows, d, seed=3)
        dx, dw = pt_rms.rms_norm_bwd(x, w, dy)
        rdx, rdw = pt_rms.rms_norm_bwd_plain(x, w, dy)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(dx), _np(rdx), **BF16)
        np.testing.assert_allclose(_np(dw), _np(rdw), rtol=1e-4,
                                   atol=1e-5 * np.abs(_np(rdw)).max())
        key = (cuda_device.index or 0, _launch.stream_of(x.device), d)
        if first is None:
            first, first_part = dw, pt_rms._partial_rows[key]
        elif (rows, d) == (8192, 1536):
            assert torch.equal(dw, first)
            assert pt_rms._partial_rows[key] is first_part
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for d in (1536, 1024, 4096):
        part = pt_rms._partial_rows[(cuda_device.index or 0,
                                     _launch.stream_of(x.device), d)]
        assert part.shape == (2 * sms, d)


def _block_args(dev, dtype, b=2, s=37, nh=4, nkv=2, d=64, ffn=320):
    hidden = nh * d
    shapes = [(b, s, nh, d), (b, s, nkv, d), (b, s, nkv, d), (b, s, hidden)]
    args = [_rand(dev, dtype, *sh, seed=10 + i) for i, sh in
            enumerate(shapes)]
    args.append(1.0 + 0.1 * _rand(dev, "float32", hidden, seed=14))
    for i, sh in enumerate([(nh * d, hidden), (hidden, ffn), (hidden, ffn),
                            (ffn, hidden)]):
        args.append(_rand(dev, dtype, *sh, scale=0.05, seed=15 + i))
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_kernel_matches_twin(cuda_device, dtype):
    """GQA 4:2, head_dim 64, s=37 (a ragged last 16-row tile) and ffn 320
    (a ragged last 256-column block). Rows are sums of several products:
    atol scaled by the output's largest magnitude."""
    args = _block_args(cuda_device, dtype)
    out = pt_fb.fused_block(*args, eps=1e-5)
    ref = pt_fb.fused_block_plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    r = _np(ref)
    np.testing.assert_allclose(_np(out), r, rtol=tol["rtol"],
                               atol=tol["atol"] * np.abs(r).max())


@pytest.mark.cuda
def test_fused_block_gradients_on_the_card_match_the_cpu_twins(cuda_device):
    """fp32 gradients of the fused block through the CUDA kernels (flash
    and RMSNorm, forward and backward, in the recompute) against the
    same Function on the CPU twins."""
    args = _block_args(cuda_device, "float32")
    dy = _rand(cuda_device, "float32", *args[3].shape, seed=30)
    grads = {}
    for dev in ("cuda", "cpu"):
        ins = [a.detach().to(dev).requires_grad_(True) for a in args]
        out = pt_inc.fused_block(*ins, eps=1e-5)
        grads[dev] = torch.autograd.grad(out, ins, dy.to(dev))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        ref = _np(b)
        np.testing.assert_allclose(_np(a), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("d,nh,nkv,ffn", [(64, 6, 2, 320), (96, 4, 2, 320),
                                          (128, 3, 1, 320), (80, 3, 1, 328)])
def test_fused_block_chain_matches_twin(cuda_device, d, nh, nkv, ffn):
    """bf16 on the chain (#1, the o-projection GEMM, #5, gate/up, down) at
    head dims 64, 96 (#1's edge route inside), 128 and 80: s=37 (74 rows,
    a ragged 128-row tile), hidden 384 or 240 (no multiple of 256; 240 a
    ragged 64-deep K), ffn 320 or 328 (ragged 128-column gate/up tiles;
    328 a ragged K of the down GEMM). One launch count a call, none of
    #1's wrapper; a second call bitwise; atol scaled by the output's
    largest magnitude."""
    args = _block_args(cuda_device, "bfloat16", nh=nh, nkv=nkv, d=d, ffn=ffn)
    assert pt_fb.route(args[0].shape, nh * d, ffn, torch.bfloat16,
                       True) == "chain"
    n0, f0 = pt_fb.launches, pt_flash.launches
    out = pt_fb.fused_block(*args, eps=1e-5)
    again = pt_fb.fused_block(*args, eps=1e-5)
    ref = pt_fb.fused_block_plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    assert pt_fb.launches - n0 == 2 and pt_flash.launches == f0
    assert torch.equal(out, again)
    r = _np(ref)
    np.testing.assert_allclose(_np(out), r, rtol=BF16["rtol"],
                               atol=BF16["atol"] * np.abs(r).max())


@pytest.mark.cuda
def test_fused_block_misaligned_bf16_takes_the_edge_kernel(cuda_device):
    """bf16 on bases 2 bytes off alignment (TMA cannot map them) runs the
    edge kernel, and matches the twin as the aligned chain does."""
    args = _block_args(cuda_device, "bfloat16")
    odd = []
    for i, t in enumerate(args):
        if i == 4:      # wn: the wrapper's fp32 copy is its own
            odd.append(t)
            continue
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        odd.append(flat[1:].view(t.shape).copy_(t))
    assert odd[0].data_ptr() % 16 == 2
    assert pt_fb.route(odd[0].shape, odd[3].shape[-1], odd[6].shape[-1],
                       torch.bfloat16, False) == "edge"
    out = pt_fb.fused_block(*odd, eps=1e-5)
    ref = pt_fb.fused_block_plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    r = _np(ref)
    np.testing.assert_allclose(_np(out), r, rtol=BF16["rtol"],
                               atol=BF16["atol"] * np.abs(r).max())


# grouped GEMMs: 4 experts of c_pad 128 (two row tiles), one empty, one
# full, one ending mid-tile; K 88 and N 200 are no multiples of the tiles.
# At c_pad 192 (a multiple of 64, not of 128) an expert's second 128-row
# tile runs past its end, and one count (130) ends just inside it.
_GG_COUNTS = [70, 0, 128, 3]
_GG_COUNTS_BY_CPAD = {128: _GG_COUNTS, 192: [130, 0, 192, 3]}


def _gg_inputs(dev, x_dtype, w_dtype, k=88, n=200, c_pad=128, seed=40):
    """Expert-major x with zero rows past each count, w [E, K, N], counts."""
    cnt = _GG_COUNTS_BY_CPAD[c_pad]
    x = _rand("cpu", "float32", len(cnt) * c_pad, k, seed=seed)
    for e, c in enumerate(cnt):
        x[e * c_pad + c:(e + 1) * c_pad] = 0
    w = _rand(dev, w_dtype, len(cnt), k, n, scale=0.1, seed=seed + 1)
    counts = torch.tensor(cnt, dtype=torch.int32, device=dev)
    return x.to(dev, getattr(torch, x_dtype)), w, counts


def _gg_close(got, want, tol):
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(ref).max(), 1))


def _shifted(t):
    """A contiguous copy of ``t`` whose base sits one element past an
    allocation's (16-byte aligned) start: 2 bytes off for bf16."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype,c_pad,odd", [
    pytest.param("bfloat16", "bfloat16", 128, None,
                 id="bfloat16-bfloat16-128"),
    pytest.param("float32", "float32", 128, None, id="float32-float32-128"),
    pytest.param("float32", "bfloat16", 128, None, id="float32-bfloat16-128"),
    pytest.param("bfloat16", "bfloat16", 192, None,
                 id="bfloat16-bfloat16-192"),
    # the WMMA route: K and N no multiples of 8, or x 2 bytes off alignment
    pytest.param("bfloat16", "bfloat16", 128, "kn", id="bf16-wmma-k70-n37"),
    pytest.param("bfloat16", "bfloat16", 192, "shift",
                 id="bf16-wmma-misaligned-x")])
def test_gmm_and_gmm2_kernels_match_twins(cuda_device, x_dtype, w_dtype,
                                          c_pad, odd):
    """gmm, gmm2 and the transposed gmm of the backward: the twin's values
    (zeros past each count included) at the tier of x's dtype, and a
    second launch gives the same bits; every output is exactly zero past
    each count. Shapes TMA cannot map (K or N no multiple of 8, a
    misaligned base) take the WMMA kernels."""
    k, n = (70, 37) if odd == "kn" else (88, 200)
    x, w, counts = _gg_inputs(cuda_device, x_dtype, w_dtype, k=k, n=n,
                              c_pad=c_pad)
    if odd == "shift":
        x = _shifted(x)
    assert pt_gg._tma_ok(k, n, x, w) == (odd is None)
    w2 = _rand(cuda_device, w_dtype, *w.shape, scale=0.1, seed=50)
    tol = FP32 if x_dtype == "float32" else BF16
    _gg_close(pt_gg.gmm(x, w, counts), pt_gg.gmm_plain(x, w, counts), tol)
    outs = pt_gg.gmm2(x, w, w2, counts)
    assert all(torch.equal(a, b)
               for a, b in zip(outs, pt_gg.gmm2(x, w, w2, counts)))
    for got, want in zip(outs, pt_gg.gmm2_plain(x, w, w2, counts)):
        _gg_close(got, want, tol)
    dy = pt_gg.gmm(x, w, counts)
    dx = pt_gg.gmm_t(dy, w, counts)
    assert torch.equal(dx, pt_gg.gmm_t(dy, w, counts))
    _gg_close(dx, pt_gg.gmm_plain(dy, w, counts, trans_w=True), tol)
    for e, c in enumerate(_GG_COUNTS_BY_CPAD[c_pad]):
        if c < c_pad:
            for out in (dy, dx) + tuple(outs):
                assert float(out[e * c_pad + c:(e + 1) * c_pad].abs()
                             .max()) == 0.0


def _tgmm_counts(c_pad):
    """Counts 70 (c_pad 128: ``_GG_COUNTS``) or 130, each ending inside a
    64-token stage, 0, c_pad and 3."""
    return [70 if c_pad < 192 else 130, 0, c_pad, 3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,case", [
    pytest.param("float32", {}, id="float32"),
    pytest.param("bfloat16", {}, id="bfloat16"),
    # the wgmma route at c_pad 128, 192 and 4096 and the train-moe widths
    pytest.param("bfloat16", dict(c_pad=192, k=1024, n=704),
                 id="bf16-cpad192-k1024-n704"),
    pytest.param("bfloat16", dict(c_pad=4096, k=704, n=1024),
                 id="bf16-cpad4096-k704-n1024"),
    pytest.param("bfloat16", dict(c_pad=128, k=200, n=72),
                 id="bf16-cpad128-k200-n72"),
    pytest.param("bfloat16", dict(c_pad=192, k=200, n=72, nan=True),
                 id="bf16-nan-in-dead-rows"),
    # the WMMA route: K and N no multiples of 8, x 2 bytes off alignment
    pytest.param("bfloat16", dict(c_pad=192, k=70, n=37, shift=True),
                 id="bf16-wmma-k70-n37-misaligned")])
def test_tgmm_kernel_matches_twin_bitwise_on_repeat(cuda_device, dtype, case):
    """dw fp32 over each expert's live rows only: the rows past a count
    hold noise here, which neither the kernel nor the twin may read
    (NaN and 1e30 in one case: the same bits as with zeros there)."""
    c_pad, k, n = case.get("c_pad", 128), case.get("k", 88), case.get("n", 200)
    cnt = _tgmm_counts(c_pad)
    counts = torch.tensor(cnt, dtype=torch.int32, device=cuda_device)
    x = _rand(cuda_device, dtype, len(cnt) * c_pad, k, seed=60)
    dy = _rand(cuda_device, dtype, x.shape[0], n, seed=61)
    if case.get("shift"):
        x = _shifted(x)
    assert pt_gg._tma_ok(k, n, x, dy) == (not case.get("shift"))
    dw = pt_gg.tgmm(x, dy, counts)
    assert dw.dtype == torch.float32 and dw.shape == (4, k, n)
    assert torch.equal(dw, pt_gg.tgmm(x, dy, counts))
    assert float(dw[1].abs().max()) == 0.0          # the empty expert
    ref = _np(pt_gg.tgmm_plain(x, dy, counts))
    np.testing.assert_allclose(_np(dw), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    if case.get("nan"):
        dead = (torch.arange(c_pad, device=cuda_device)[None, :]
                >= counts[:, None]).reshape(-1)
        xn = x.masked_fill(dead[:, None], float("nan"))
        dyn = dy.masked_fill(dead[:, None], 1e30)
        assert torch.equal(pt_gg.tgmm(xn, dyn, counts), dw)


@pytest.mark.cuda
def test_expert_mlp_gradients_on_the_card_match_the_cpu_twins(cuda_device):
    """fp32 gradients of the expert MLP through gmm2, gmm, the dx gmm and
    tgmm on the card against the same Functions on the CPU twins."""
    from paddle_tpu_torch import flags
    x, wg, counts = _gg_inputs(cuda_device, "float32", "float32", k=96,
                               n=72)
    wu = _rand(cuda_device, "float32", *wg.shape, scale=0.1, seed=70)
    wd = _rand(cuda_device, "float32", 4, 72, 96, scale=0.1, seed=71)
    for fused in (True, False):
        flags.set_flags({"moe_fused_wi": fused})
        try:
            grads = {}
            for dev in ("cuda", "cpu"):
                ins = [t.detach().to(dev).requires_grad_(True)
                       for t in (x, wg, wu, wd)]
                y = pt_gg.expert_mlp(ins[0], counts.to(dev), *ins[1:])
                grads[dev] = torch.autograd.grad(y.square().sum(), ins)
        finally:
            flags.set_flags({"moe_fused_wi": True})
        for a, b in zip(grads["cuda"], grads["cpu"]):
            _gg_close(a, b, dict(rtol=1e-5, atol=1e-5))


# paged decode attention: 5 sequences over 16-token blocks, one empty, one
# ending mid-block, one filling its last block; 12-wide tables whose tails
# name blocks the kernel must not read
_PAGED_LENS = [13, 0, 48, 1, 170]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("d,hq,kv", [(128, 8, 2), (64, 4, 4)])
def test_paged_decode_kernel_matches_twin(cuda_device, q_dtype, kv_dtype, d,
                                          hq, kv):
    g = torch.Generator().manual_seed(80)
    bs, nb = 16, 64
    kc = torch.randn(nb * bs, kv, d, generator=g)
    vc = torch.randn(nb * bs, kv, d, generator=g)
    tables = torch.randperm(nb, generator=g)[:60].reshape(5, 12)
    q = torch.randn(5, hq, d, generator=g)
    kvt, qt = getattr(torch, kv_dtype), getattr(torch, q_dtype)
    args = [q.to(cuda_device, qt), kc.to(cuda_device, kvt),
            vc.to(cuda_device, kvt), tables.to(cuda_device, torch.int32),
            torch.tensor(_PAGED_LENS, dtype=torch.int32, device=cuda_device),
            bs]
    out = pt_paged.paged_decode_attention(*args)
    ref = pt_paged.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == (5, hq, d)
    if q_dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    else:
        # a few bf16 ulps of each sequence's own scale (the long row's
        # outputs are small)
        for o, r in zip(_np(out), _np(ref)):
            np.testing.assert_allclose(o, r, rtol=BF16["rtol"],
                                       atol=BF16["atol"] * np.abs(r).max())
    assert float(out[1].abs().max()) == 0.0          # the empty sequence


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("d", [96, 256])
def test_paged_decode_kernel_head_dims_match_twin(cuda_device, q_dtype,
                                                  kv_dtype, d):
    """#9 at head dims 96 and 256 (padded to 128 and 256; over fp32 pages
    at 256 one page stage, a lane owning two chunks of a row) against its
    twin, pages of 64 rows, GQA 4:1; the empty sequence exactly 0."""
    g = torch.Generator().manual_seed(81)
    bs, nb, hq, kv = 64, 24, 8, 2
    kc = torch.randn(nb * bs, kv, d, generator=g)
    vc = torch.randn(nb * bs, kv, d, generator=g)
    tables = torch.randperm(nb, generator=g)[:20].reshape(5, 4)
    q = torch.randn(5, hq, d, generator=g)
    kvt, qt = getattr(torch, kv_dtype), getattr(torch, q_dtype)
    args = [q.to(cuda_device, qt), kc.to(cuda_device, kvt),
            vc.to(cuda_device, kvt), tables.to(cuda_device, torch.int32),
            torch.tensor([13, 0, 130, 1, 256], dtype=torch.int32,
                         device=cuda_device), bs]
    out = pt_paged.paged_decode_attention(*args)
    ref = pt_paged.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == (5, hq, d)
    if q_dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), **FP32)
    else:
        for o, r in zip(_np(out), _np(ref)):
            np.testing.assert_allclose(o, r, rtol=BF16["rtol"],
                                       atol=BF16["atol"] * np.abs(r).max())
    assert float(out[1].abs().max()) == 0.0


def _scan_inputs(dev, dtype, b, l, h, dh, ds, seed=90):
    rs = np.random.RandomState(seed)
    t = getattr(torch, dtype)
    x = torch.from_numpy(rs.randn(b, l, h, dh).astype(np.float32)).to(dev, t)
    dt = torch.from_numpy((np.abs(rs.randn(b, l, h)) * 0.1 + 0.01)
                          .astype(np.float32)).to(dev)
    A = torch.from_numpy((-np.abs(rs.randn(h)) - 0.1).astype(np.float32)
                         ).to(dev)
    B = torch.from_numpy(rs.randn(b, l, ds).astype(np.float32)).to(dev, t)
    C = torch.from_numpy(rs.randn(b, l, ds).astype(np.float32)).to(dev, t)
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,dh,ds,chunk", [(100, 32, 16, 32), (300, 64, 64,
                                                               None)])
def test_selective_scan_kernel_matches_twin(cuda_device, dtype, l, dh, ds,
                                            chunk):
    """y and the final state against the chunked twin at the same chunk,
    for lengths that are no multiple of it; a second launch gives the
    same bits. y's elements are sums over the chunk and the state: atol
    scaled by each tensor's largest magnitude."""
    x, dt, A, B, C = _scan_inputs(cuda_device, dtype, 2, l, 3, dh, ds)
    with torch.no_grad():
        pt_ss.launches = 0
        y, s = pt_ss.selective_scan(x, dt, A, B, C, chunk=chunk)
        y2, s2 = pt_ss.selective_scan(x, dt, A, B, C, chunk=chunk)
        assert pt_ss.launches == 2
        L = chunk or pt_ss.resolve_chunk(l)
        lp = -(-l // L) * L
        dtf = dt.float()
        la = torch.nn.functional.pad(dtf * A, (0, 0, 0, lp - l))
        dtx = torch.nn.functional.pad((dtf[..., None] * x.float()).to(x.dtype),
                                      (0, 0, 0, 0, 0, lp - l))
        pad = (0, 0, 0, lp - l)
        ry, rs = pt_ss._scan_reference(
            dtx, la.transpose(1, 2), torch.nn.functional.pad(B, pad),
            torch.nn.functional.pad(C, pad), L)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert y.dtype == x.dtype and s.dtype == torch.float32
    tol = FP32 if dtype == "float32" else BF16
    for got, want in ((y, ry[:, :l]), (s, rs)):
        ref = _np(want)
        np.testing.assert_allclose(_np(got), ref, rtol=tol["rtol"],
                                   atol=10 * tol["atol"] * np.abs(ref).max())


# the scan's launch plans (csrc/selective_scan.cu: chunk state, state pass,
# chunk out): one chunk, two, eight and sixteen, padded tails, batch 1-4,
# d_state 16/64/128, head dims 32/64/128, chunks under one 64-row tile, of
# one, two and four tiles, and heads enough to be split into groups
_SCAN_PLANS = [(1, 64, 3, 32, 16, 64), (2, 128, 4, 64, 64, 64),
               (3, 1000, 5, 32, 16, 128), (4, 1024, 2, 64, 128, 64),
               (2, 500, 3, 128, 16, 32), (1, 1023, 64, 32, 16, 128),
               (2, 1024, 48, 32, 16, 256), (1, 40, 2, 32, 128, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,dh,ds,chunk", _SCAN_PLANS)
def test_selective_scan_plans_match_twin(cuda_device, dtype, b, l, h, dh,
                                         ds, chunk):
    """The chunk-parallel scan against the chunked twin at every branch of
    its launch plan: y and the final state within the smoke's tolerance
    (fp32 1e-5, bf16 2e-2, each x the tensor's largest magnitude plus the
    same relative term), and a second launch bitwise equal."""
    x, dt, A, B, C = _scan_inputs(cuda_device, dtype, b, l, h, dh, ds,
                                  seed=l + dh)
    with torch.no_grad():
        pt_ss.launches = 0
        y, s = pt_ss.selective_scan(x, dt, A, B, C, chunk=chunk)
        y2, s2 = pt_ss.selective_scan(x, dt, A, B, C, chunk=chunk)
        assert pt_ss.launches == 2
        lp = -(-l // chunk) * chunk
        dtf = dt.float()
        la = torch.nn.functional.pad(dtf * A, (0, 0, 0, lp - l))
        dtx = torch.nn.functional.pad((dtf[..., None] * x.float()).to(x.dtype),
                                      (0, 0, 0, 0, 0, lp - l))
        pad = (0, 0, 0, lp - l)
        ry, rs = pt_ss._scan_reference(
            dtx, la.transpose(1, 2), torch.nn.functional.pad(B, pad),
            torch.nn.functional.pad(C, pad), chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((y, ry[:, :l]), (s, rs)):
        g, w = _np(got), _np(want)
        assert (np.abs(g - w) <= tol * np.abs(w).max()
                + tol * np.abs(w)).all(), np.abs(g - w).max()


def _scan_padded(x, dt, A, B, C, L):
    """The padded operands ``selective_scan`` hands the chunked scan."""
    l = x.shape[1]
    lp = -(-l // L) * L
    dtf = dt.float()
    pad = (0, 0, 0, lp - l)
    la = torch.nn.functional.pad(dtf * A, pad).transpose(1, 2).contiguous()
    dtx = torch.nn.functional.pad((dtf[..., None] * x.float()).to(x.dtype),
                                  (0, 0, 0, 0, 0, lp - l)).contiguous()
    return (dtx, la, torch.nn.functional.pad(B, pad).contiguous(),
            torch.nn.functional.pad(C, pad).contiguous())


def _scaled_ok(got, want, tol):
    g, w = _np(got), _np(want)
    return bool((np.abs(g - w) <= tol * np.abs(w).max()
                 + tol * np.abs(w)).all()), float(np.abs(g - w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,dh,ds,chunk", _SCAN_PLANS)
def test_selective_scan_bwd_kernel_matches_twin(cuda_device, dtype, b, l, h,
                                                dh, ds, chunk):
    """The scan's backward kernel at every branch of the forward's plans,
    from the forward kernel's saved states and with a final-state
    cotangent: (d_dtx, d_la, dB, dC) against ``scan_chunked_bwd_plain`` on
    the same inputs within the smoke's tolerance (fp32 1e-5, bf16 2e-2,
    each x the twin's largest magnitude plus the same relative term), and a
    second launch bitwise equal; the saved states against the twin's."""
    x, dt, A, B, C = _scan_inputs(cuda_device, dtype, b, l, h, dh, ds,
                                  seed=l + dh + 1)
    args = _scan_padded(x, dt, A, B, C, chunk)
    rs = np.random.RandomState(l + ds)
    dy = torch.from_numpy(rs.randn(*args[0].shape).astype(np.float32)).to(
        cuda_device, args[0].dtype)
    dsf = torch.from_numpy(rs.randn(b, h, ds, dh).astype(np.float32)).to(
        cuda_device)
    with torch.no_grad():
        _, _, states = pt_ss._scan_launch(*args, chunk)
        _, _, twin_states = pt_ss._scan_reference(*args, chunk,
                                                  with_states=True)
        pt_ss.launches_bwd = 0
        got = pt_ss.scan_chunked_bwd(*args, states, dy, dsf, chunk)
        again = pt_ss.scan_chunked_bwd(*args, states, dy, dsf, chunk)
        assert pt_ss.launches_bwd == 2
        want = pt_ss.scan_chunked_bwd_plain(*args, states, dy, dsf, chunk)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _scaled_ok(states, twin_states, tol)[0]
    for name, g, g2, w in zip(("d_dtx", "d_la", "dB", "dC"), got, again,
                              want):
        assert torch.equal(g, g2), name
        assert g.dtype == w.dtype, name
        ok, err = _scaled_ok(g, w, tol)
        assert ok, (name, err)


def _misaligned(t):
    """``t``'s values in a buffer whose base is 2 bytes past a 16-byte
    boundary (TMA cannot map it)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    v = buf[1:1 + t.numel()].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype,b,l,h,dh,ds,chunk,misalign", [
    # the wgmma route: the train shape's batch, length and widths with 7
    # heads (4 head groups of 2, 2, 2 and 1: the group count does not
    # divide H), and dh / ds at 128
    ("wgmma", "bfloat16", 4, 2048, 7, 64, 64, 256, False),
    ("wgmma", "bfloat16", 1, 500, 3, 128, 128, 128, False),
    ("wgmma", "bfloat16", 2, 512, 5, 64, 128, 256, False),
    ("wgmma", "bfloat16", 2, 384, 7, 128, 64, 128, False),
    # the edge route: bf16 at head dim 32 and 24, a misaligned base, fp32
    ("edge", "bfloat16", 2, 300, 3, 32, 32, 128, False),
    ("edge", "bfloat16", 2, 256, 3, 24, 16, 64, False),
    ("edge", "bfloat16", 2, 256, 3, 64, 64, 128, True),
    ("edge", "float32", 2, 300, 3, 64, 64, 128, False)])
def test_selective_scan_bwd_routes(cuda_device, route, dtype, b, l, h, dh,
                                   ds, chunk, misalign):
    """The backward on each route: (d_dtx, d_la, dB, dC) against
    ``scan_chunked_bwd_plain`` and against autograd through the chunked
    twin on the card (bf16 2e-2, fp32 1e-5, scaled as above), a second
    launch bitwise; the route the wrapper picks is the plan's."""
    x, dt, A, B, C = _scan_inputs(cuda_device, dtype, b, l, h, dh, ds,
                                  seed=l + h)
    args = _scan_padded(x, dt, A, B, C, chunk)
    lp = args[0].shape[1]
    rs = np.random.RandomState(h + ds)
    dy = torch.from_numpy(rs.randn(*args[0].shape).astype(np.float32)).to(
        cuda_device, args[0].dtype)
    dy[:, l:] = 0
    dsf = torch.from_numpy(rs.randn(b, h, ds, dh).astype(np.float32)).to(
        cuda_device)
    with torch.no_grad():
        _, _, states = pt_ss._scan_launch(*args, chunk)
    kargs = [_misaligned(t) if misalign else t
             for t in (args[0], args[2], args[3], dy)]
    aligned = all(t.data_ptr() % 16 == 0 for t in kargs)
    assert aligned != misalign
    assert pt_ss.bwd_route(args[0].shape, ds, chunk, args[0].dtype,
                           aligned) == route
    plan = pt_ss.bwd_launch_plan(b, lp, h, dh, ds, chunk,
                                 args[0].element_size(),
                                 route=None if aligned else "edge")
    assert plan["route"] == route
    if route == "wgmma" and h == 7 and dh == 64:
        assert h % plan["groups"] != 0
    bwd = (kargs[0], args[1], kargs[1], kargs[2], states, kargs[3], dsf,
           chunk)
    with torch.no_grad():
        pt_ss.launches_bwd = 0
        got = pt_ss.scan_chunked_bwd(*bwd)
        again = pt_ss.scan_chunked_bwd(*bwd)
        assert pt_ss.launches_bwd == 2
        want = pt_ss.scan_chunked_bwd_plain(*args, states, dy, dsf, chunk)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    ty, ts = pt_ss._scan_reference(*leaves, chunk)
    ((ty.float() * dy.float()).sum() + (ts * dsf).sum()).backward()
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, g2, w, a in zip(("d_dtx", "d_la", "dB", "dC"), got, again,
                                 want, leaves):
        assert torch.equal(g, g2), name
        assert g.dtype == w.dtype, name
        ok, err = _scaled_ok(g, w, tol)
        assert ok, (name, "plain", err)
        ok, err = _scaled_ok(g, a.grad, tol)
        assert ok, (name, "autograd", err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_gradients_on_the_card(cuda_device, dtype):
    """``selective_scan`` under autograd on the card (l 300, no multiple of
    the chunk): one forward and one backward kernel launch, and the
    gradients to x, dt, A, B and C against the chunked twin's autograd on
    the CPU (fp32 1e-5, bf16 2e-2, scaled as above)."""
    ins = _scan_inputs(cuda_device, dtype, 2, 300, 3, 64, 32, seed=5)
    dy = torch.from_numpy(np.random.RandomState(6).randn(2, 300, 3, 64)
                          .astype(np.float32)).to(cuda_device, ins[0].dtype)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in ins]
        pt_ss.launches = pt_ss.launches_bwd = 0
        y, s = pt_ss.selective_scan(*leaves, chunk=64)
        ((y.float() * dy.to(dev).float()).sum() + s.square().sum()).backward()
        if dev == "cuda":
            assert (pt_ss.launches, pt_ss.launches_bwd) == (1, 1)
        grads[dev] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip("x dt A B C".split(), grads["cuda"], grads["cpu"]):
        ok, err = _scaled_ok(g, w, tol)
        assert ok, (name, err)


def _hybrid_train_model(**kw):
    from paddle_tpu_torch.models import HybridSSMForCausalLM, ssm_tiny_config
    cfg = ssm_tiny_config(hidden_size=256, intermediate_size=512,
                          num_attention_heads=4, num_key_value_heads=2,
                          num_hidden_layers=2, layer_pattern="SA",
                          ssm_head_dim=64, ssm_state_size=32,
                          dtype="bfloat16", **kw)
    return HybridSSMForCausalLM(cfg, seed=4)


def _loss_grads(model, ids):
    loss, _ = model(ids, labels=ids)
    loss.backward()
    grads = [p.grad.float() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _grad_dist(a, b):
    num = sum(float((x - y).double().square().sum()) for x, y in zip(a, b))
    return (num / sum(float(y.double().square().sum()) for y in b)) ** 0.5


@pytest.mark.cuda
def test_hybrid_train_step_on_the_card(cuda_device):
    """One bf16 hybrid step (an SSM and an attention layer, 320 tokens) on
    the card launches the scan's forward and backward kernels once each,
    and its gradients are no further from an fp32 copy's on the CPU than
    1.25x the same bf16 model's on the CPU twins are."""
    import copy
    from paddle_tpu_torch.ops import kernels
    model = _hybrid_train_model()
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, size=(2, 160)).astype(np.int32)).to(cuda_device)
    kernels.reset_launch_counts()
    loss_k, g_k = _loss_grads(model, ids)
    counts = kernels.launch_counts()
    assert counts["selective_scan"] == 1 and \
        counts["selective_scan_bwd"] == 1, counts
    cpu = copy.deepcopy(model).cpu()
    loss_t, g_t = _loss_grads(cpu, ids.cpu())
    loss_e, g_e = _loss_grads(cpu.float(), ids.cpu())
    g_k = [g.cpu() for g in g_k]
    r_k, r_t = _grad_dist(g_k, g_e), _grad_dist(g_t, g_e)
    assert abs(loss_k - loss_e) <= 2e-2 * abs(loss_e), (loss_k, loss_e)
    assert r_k <= 1.25 * r_t + 1e-6, (r_k, r_t)


@pytest.mark.cuda
def test_recompute_replays_the_scan_bit_for_bit(cuda_device):
    """With ``recompute`` the backward replays each layer: the scan kernel
    runs twice a step and the replay's y and state equal the forward's bit
    for bit; loss and gradients equal the step without recompute at the
    reference's tolerance (loss rtol 1e-5, gradients rtol 1e-4 / atol
    1e-6)."""
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, size=(2, 160)).astype(np.int32)).to(cuda_device)
    plain = _loss_grads(_hybrid_train_model(), ids)
    model = _hybrid_train_model(recompute=True)
    outs, launch = [], pt_ss._scan_launch

    def recording(*a):
        out = launch(*a)
        outs.append([t.clone() for t in out[:2]])
        return out
    pt_ss._scan_launch = recording
    try:
        loss, grads = _loss_grads(model, ids)
    finally:
        pt_ss._scan_launch = launch
    assert len(outs) == 2
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    np.testing.assert_allclose(loss, plain[0], rtol=1e-5)
    for g, w in zip(grads, plain[1]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-6)


# #10's schedule (producer warps scoring ahead of a consumer warp a head,
# the group split over blocks) must not move a bit: decode rows at lengths
# of 0, 1, a page, a page and one, more pages than the ring holds and a
# long context, enough of them that the full call takes 4 or 2 heads a
# block while each row alone takes 1
_RING_LENS = [0, 1, 63, 64, 65, 5 * 64 + 1, 1000, 777]


def _ring_inputs(dev, group, bs, mode, q_dtype, d, hkv=8, t=40, seed=0):
    from paddle_tpu_torch.quantization import kv as kvq
    g = torch.Generator().manual_seed(seed + bs + group + d)
    width = -(-max(_RING_LENS) // bs)
    tables = torch.randperm(t * width, generator=g).reshape(t, width)
    kq, ks = kvq.quantize_kv(torch.randn(t * width * bs, hkv, d,
                                         generator=g).to(dev), mode)
    vq, vs = kvq.quantize_kv(torch.randn(t * width * bs, hkv, d,
                                         generator=g).to(dev), mode)
    valids = [_RING_LENS[i % len(_RING_LENS)] for i in range(t)]
    q = torch.randn(t, hkv * group, d, generator=g).to(
        dev, getattr(torch, q_dtype))
    return [q, kq, vq, ks, vs, tables.to(dev, torch.int32),
            torch.arange(t, dtype=torch.int32, device=dev),
            torch.tensor(valids, dtype=torch.int32, device=dev), bs], valids


def _check_quant_schedule(args, valids, fp32):
    out = _check_split_call(pt_quant, pt_quant.ragged_paged_attention_quant,
                            pt_quant.ragged_paged_attention_quant_plain, args,
                            valids, "max" if fp32 else "bf16")
    q, rows, vals = args[0], args[-3], args[-2]
    for i in range(len(_RING_LENS)):
        alone = pt_quant.ragged_paged_attention_quant(
            q[i:i + 1].contiguous(), *args[1:-3], rows[i:i + 1].contiguous(),
            vals[i:i + 1].contiguous(), args[-1])
        assert torch.equal(alone[0], out[i]), (i, valids[i])


@pytest.mark.cuda
@pytest.mark.parametrize("hkv", [4, 8])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
def test_quant_schedule_keeps_each_heads_bits(cuda_device, group, bs, hkv):
    """#10 over int8 pages, fp32 q, at groups 1-32 and block sizes 16-128:
    against its twin (1e-4 x max|twin|), two launches bitwise, pads 0, and
    each decode row alone (the pipelined schedule, one head a block)
    bitwise its row of the full call: 40 tokens over 8 kv heads take the
    wide schedule, over 4 the pipelined one with 1, 2 or 4 heads a block."""
    args, valids = _ring_inputs(cuda_device, group, bs, "int8", "float32",
                                128, hkv=hkv)
    t, hq, _ = args[0].shape
    plan = pt_quant.launch_plan(t, hq, hkv, 128, bs, args[5].shape[1])
    assert plan["stages"] >= 2
    assert plan["schedule"] == ("wide" if hkv == 8 else "pipelined")
    _check_quant_schedule(args, valids, True)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 256])
def test_quant_schedule_head_dims(cuda_device, d, mode, q_dtype):
    """The same checks at head dims 16-256, int8 and fp8 pages, fp32 and
    bf16 q (group 4, block 64)."""
    args, valids = _ring_inputs(cuda_device, 4, 64, mode, q_dtype, d)
    _check_quant_schedule(args, valids, q_dtype == "float32")


@pytest.mark.cuda
def test_hybrid_engine_on_the_card(cuda_device):
    """A small fp32 hybrid (head_dim 64, the flash kernel's) served on the
    card in both modes: the scan, flash, ragged and paged kernels each
    launch, compiled and eager agree, every slot's state is zero and every
    page free after the drain."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    from paddle_tpu_torch.models import HybridSSMForCausalLM, ssm_tiny_config
    from paddle_tpu_torch.ops import kernels
    cfg = ssm_tiny_config(hidden_size=256, num_attention_heads=4,
                          num_key_value_heads=2, num_hidden_layers=4,
                          layer_pattern="SA", ssm_head_dim=32)
    model = HybridSSMForCausalLM(cfg, seed=3)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6] * 5, [2, 7, 1, 8], list(range(70))]
    outs = {}
    for mode in ("compiled", "eager"):
        kernels.reset_launch_counts()
        eng = GenerationEngine(model, max_seqs=4, max_seq_len=128,
                               block_size=16, mode=mode)
        outs[mode] = eng.generate([GenerationRequest(i, p, max_new_tokens=9)
                                   for i, p in enumerate(prompts)])
        counts = kernels.launch_counts()
        assert counts["selective_scan"] == 3 * 2
        assert counts["flash_attention_fwd"] == 3 * 2
        steps = eng.stats["steps"]
        attn = "ragged_paged_attention" if mode == "compiled" \
            else "paged_attention"
        assert counts[attn] == steps * 2, (mode, counts, steps)
        assert eng.cache.free_blocks == eng.cache.num_blocks
        for st in eng._sstate:    # the pads' spare row is no slot's
            if st is not None:
                assert float(st["conv"][:4].abs().sum()) == 0.0
                assert float(st["ssm"][:4].abs().sum()) == 0.0
    same = sum(a == b for i in outs["eager"] for a, b in
               zip(outs["eager"][i], outs["compiled"][i]))
    assert same >= 0.9 * 27, outs


# #10 at the chip smoke's four shapes: (a) #8's timing shape over int8
# pages, (b) the serve-quant step's, (c) (a) over fp8 pages, (d) (a) with a
# bf16 q and pads
_RAGGED_ROWS = list(range(7)) + [7] * 64 + [0]
_RAGGED_VALIDS = [130, 257, 385, 512, 640, 771, 1000] + list(
    range(449, 513)) + [0]
_SERVE_LENS = np.random.RandomState(2).randint(1, 528, size=64).tolist()
_QUANT_CASES = {
    "a_int8": (32, 8, 128, _RAGGED_ROWS, _RAGGED_VALIDS, 8, 32, "int8",
               "float32"),
    "b_serve_quant": (16, 8, 64, list(range(64)) + [64] * 64,
                      _SERVE_LENS + list(range(449, 513)), 65, 16, "int8",
                      "float32"),
    "c_fp8": (32, 8, 128, _RAGGED_ROWS, _RAGGED_VALIDS, 8, 32, "fp8",
              "float32"),
    "d_bf16_pads": (32, 8, 128, _RAGGED_ROWS,
                    [0 if i in (3, 40, 70) else v
                     for i, v in enumerate(_RAGGED_VALIDS)], 8, 32, "int8",
                    "bfloat16")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_QUANT_CASES))
def test_quant_ragged_kernel_matches_twin(cuda_device, case):
    """Ragged attention over quantized pages (#10) against its twin: an
    fp32 output to 1e-4 x the twin's largest magnitude (the kernel folds
    the scales into scores and softmax weights, the twin into the pages),
    a bf16 one at the bf16 tier; pads exactly 0; a second launch gives the
    same bits."""
    from paddle_tpu_torch.quantization import kv as kvq
    hq, hkv, d, rows, valids, seqs, width, mode, q_dtype = _QUANT_CASES[case]
    g = torch.Generator().manual_seed(100)
    bs = 64
    tables = torch.randperm(seqs * width, generator=g).reshape(seqs, width)
    kq, ks = kvq.quantize_kv(torch.randn(seqs * width * bs, hkv, d,
                                         generator=g).to(cuda_device), mode)
    vq, vs = kvq.quantize_kv(torch.randn(seqs * width * bs, hkv, d,
                                         generator=g).to(cuda_device), mode)
    q = torch.randn(len(rows), hq, d, generator=g).to(
        cuda_device, getattr(torch, q_dtype))
    args = [q, kq, vq, ks, vs, tables.to(cuda_device, torch.int32),
            torch.tensor(rows, dtype=torch.int32, device=cuda_device),
            torch.tensor(valids, dtype=torch.int32, device=cuda_device), bs]
    pt_quant.launches = 0
    out = pt_quant.ragged_paged_attention_quant(*args)
    again = pt_quant.ragged_paged_attention_quant(*args)
    ref = pt_quant.ragged_paged_attention_quant_plain(*args)
    torch.cuda.synchronize()
    assert pt_quant.launches == 2
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.equal(out, again)
    top = np.abs(_np(ref)).max()
    if q_dtype == "float32":
        assert np.abs(_np(out) - _np(ref)).max() <= 1e-4 * top
    else:
        np.testing.assert_allclose(_np(out), _np(ref), **BF16)
    pads = [i for i, v in enumerate(valids) if v == 0]
    assert not pads or float(out[pads].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("d", [96, 256])
def test_quant_ragged_kernel_head_dims_match_twin(cuda_device, d, mode,
                                                  q_dtype):
    """#10 at head dims 96 and 256 over int8 and fp8 pages, fp32 or bf16
    q, at case (a)'s rows and lengths with pads: tolerances as
    :func:`test_quant_ragged_kernel_matches_twin`, bitwise on repeat."""
    from paddle_tpu_torch.quantization import kv as kvq
    g = torch.Generator().manual_seed(d)
    hq, hkv, seqs, width, bs = 32, 8, 8, 32, 64
    rows = _RAGGED_ROWS
    valids = [0 if i in (3, 40) else v for i, v in enumerate(_RAGGED_VALIDS)]
    tables = torch.randperm(seqs * width, generator=g).reshape(seqs, width)
    kq, ks = kvq.quantize_kv(torch.randn(seqs * width * bs, hkv, d,
                                         generator=g).to(cuda_device), mode)
    vq, vs = kvq.quantize_kv(torch.randn(seqs * width * bs, hkv, d,
                                         generator=g).to(cuda_device), mode)
    q = torch.randn(len(rows), hq, d, generator=g).to(
        cuda_device, getattr(torch, q_dtype))
    args = [q, kq, vq, ks, vs, tables.to(cuda_device, torch.int32),
            torch.tensor(rows, dtype=torch.int32, device=cuda_device),
            torch.tensor(valids, dtype=torch.int32, device=cuda_device), bs]
    out = pt_quant.ragged_paged_attention_quant(*args)
    again = pt_quant.ragged_paged_attention_quant(*args)
    ref = pt_quant.ragged_paged_attention_quant_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and out.shape == q.shape
    if q_dtype == "float32":
        assert np.abs(_np(out) - _np(ref)).max() <= \
            1e-4 * np.abs(_np(ref)).max()
    else:
        np.testing.assert_allclose(_np(out), _np(ref), **BF16)
    assert float(out[[3, 40, len(rows) - 1]].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_engine_on_the_card(cuda_device, kv_quant):
    """A small fp32 Llama (head_dim 64) served on the card with quantized
    pages and int8 weights: the quantized kernel launches steps x layers
    times and the full-width ragged kernel never, the greedy streams equal
    the plain-twin engine's, every page is free after the drain."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.ops import kernels
    cfg = llama_tiny_config(hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, num_hidden_layers=2,
                            intermediate_size=512, vocab_size=512)
    model = LlamaForCausalLM(cfg, seed=4)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6] * 5, [2, 7, 1, 8], list(range(70))]
    outs = {}
    for use_kernel in (True, False):
        kernels.reset_launch_counts()
        eng = GenerationEngine(model, max_seqs=4, max_seq_len=128,
                               block_size=16, kv_quant=kv_quant,
                               weight_quant=True, use_kernel=use_kernel)
        outs[use_kernel] = eng.generate(
            [GenerationRequest(i, p, max_new_tokens=9)
             for i, p in enumerate(prompts)])
        counts = kernels.launch_counts()
        want = eng.stats["steps"] * 2 if use_kernel else 0
        assert counts["ragged_paged_attention_quant"] == want, counts
        assert counts["ragged_paged_attention"] == 0, counts
        assert eng.cache.k.dtype == (torch.int8 if kv_quant == "int8"
                                     else torch.float8_e4m3fn)
        assert eng.cache.free_blocks == eng.cache.num_blocks
    same = sum(a == b for i in outs[True] for a, b in
               zip(outs[True][i], outs[False][i]))
    assert same >= 0.9 * 27, outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("sq,sk,seg", [
    (200, 200, [0, 300, 100, 0, 300, 100]),     # a ring's t=0 step
    (200, 200, [100, 200, 100, 0, 300, 100]),   # KV from an earlier rank
    (150, 130, [5, 190, 77, 0, 140, 61]),       # straddling splits
    (96, 96, [0, 48, 48, 20, 500, 96]),         # rows with nothing visible
    (256, 256, [0, 384, 128, 128, 256, 128])])  # whole dead tiles
def test_segment_causal_kernels_match_twins(cuda_device, dtype, d, sq, sk,
                                            seg):
    """#3 and #4 against their twins: GQA 4:2, splits no tile divides, a
    query tile that straddles its split, rows that see no column (o = 0,
    lse = -inf), whole query and key tiles with nothing visible (a t > 0
    ring step); the backward twice, bitwise, with exact zeros in the rows
    of dq and of dk/dv that see nothing. bf16 at head dims 64 and 128 runs
    the wgmma kernels, every other case the edge route (head dims 96 and
    256 padded to 128 and 256). lse at atol 1e-5, the gradients with atol
    scaled by each tensor's largest magnitude."""
    q = _rand(cuda_device, dtype, 2, sq, 4, d, seed=21)
    k = _rand(cuda_device, dtype, 2, sk, 2, d, seed=22)
    v = _rand(cuda_device, dtype, 2, sk, 2, d, seed=23)
    do = _rand(cuda_device, dtype, 2, sq, 4, d, seed=24)
    o, lse = pt_flash.flash_attention_seg_with_lse(q, k, v, seg)
    ro, rlse = pt_flash.flash_attention_seg_plain(q, k, v, seg)
    ro = ro.contiguous()
    got = pt_flash.flash_attention_seg_bwd(q, k, v, ro, rlse, do, seg)
    again = pt_flash.flash_attention_seg_bwd(q, k, v, ro, rlse, do, seg)
    want = pt_flash.flash_attention_seg_bwd_plain(q, k, v, ro, rlse, do, seg)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_array_equal(torch.isneginf(lse).cpu().numpy(),
                                  torch.isneginf(rlse).cpu().numpy())
    fin = ~torch.isneginf(rlse)
    np.testing.assert_allclose(_np(lse[fin]), _np(rlse[fin]), rtol=1e-5,
                               atol=1e-5)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and a.dtype == c.dtype
        ref = _np(c)
        np.testing.assert_allclose(_np(a), ref, rtol=tol["rtol"],
                                   atol=tol["atol"] * np.abs(ref).max())
    _assert_unseen_zero(got, rlse, seg, sk)


def _assert_unseen_zero(grads, lse, seg, sk):
    """dq is exactly 0 in the rows that see nothing (lse -inf), dk and dv
    in the keys that no row sees."""
    dq, dk, dv = grads
    assert not dq[torch.isneginf(lse).transpose(1, 2)].any()
    gq = pt_flash.seg_positions(*seg[:3], dq.shape[1], dq.device)
    gk = pt_flash.seg_positions(*seg[3:], sk, dq.device)
    unseen = gk > gq.max()
    assert not dk[:, unseen].any() and not dv[:, unseen].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_segment_causal_backward_routes_by_alignment(cuda_device, d):
    """#4 in bf16 with q, k, v, o and dO 2 bytes off alignment takes the
    CUDA-core kernels (TMA cannot map them), aligned copies the wgmma
    kernels: each against the twin, bitwise on repeat, zeros where
    nothing is seen, and the two routes at the bf16 tier of each other."""
    sq = sk = 256
    seg = [0, 384, 128, 128, 256, 128]
    q, do = (_rand(cuda_device, "bfloat16", 1, sq, 4, d, seed=s)
             for s in (31, 34))
    k, v = (_rand(cuda_device, "bfloat16", 1, sk, 2, d, seed=s)
            for s in (32, 33))
    ro, rlse = pt_flash.flash_attention_seg_plain(q, k, v, seg)
    ro = ro.contiguous()
    aligned = (q, k, v, ro, do)
    shifted = tuple(_shifted(t) for t in aligned)
    assert pt_flash._seg_bwd_tma_ok(1, 4, 2, *aligned)
    assert not pt_flash._seg_bwd_tma_ok(1, 4, 2, *shifted)
    want = pt_flash.flash_attention_seg_bwd_plain(*aligned[:4], rlse, do,
                                                  seg)
    routes = []
    for q_, k_, v_, o_, do_ in (aligned, shifted):
        got = pt_flash.flash_attention_seg_bwd(q_, k_, v_, o_, rlse, do_, seg)
        again = pt_flash.flash_attention_seg_bwd(q_, k_, v_, o_, rlse, do_,
                                                 seg)
        torch.cuda.synchronize()
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            ref = _np(c)
            np.testing.assert_allclose(_np(a), ref, rtol=BF16["rtol"],
                                       atol=BF16["atol"] * np.abs(ref).max())
        _assert_unseen_zero(got, rlse, seg, sk)
        routes.append(got)
    for a, b in zip(*routes):
        ref = _np(b)
        np.testing.assert_allclose(_np(a), ref, rtol=BF16["rtol"],
                                   atol=BF16["atol"] * np.abs(ref).max())


def _check_fwd(o, lse, ro, rlse, tol):
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_array_equal(torch.isneginf(lse).cpu().numpy(),
                                  torch.isneginf(rlse).cpu().numpy())
    fin = ~torch.isneginf(rlse)
    np.testing.assert_allclose(_np(lse[fin]), _np(rlse[fin]), rtol=1e-5,
                               atol=1e-5)


def _check_grads(got, again, want, tol):
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and a.dtype == c.dtype
        ref = _np(c)
        np.testing.assert_allclose(_np(a), ref, rtol=tol["rtol"],
                                   atol=tol["atol"] * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 80, 96, 256])
@pytest.mark.parametrize("causal,sq,sk", [(True, 130, 130), (False, 100, 130)])
def test_flash_edge_head_dims_match_twins(cuda_device, dtype, d, causal, sq,
                                          sk):
    """#1 and #2 at head dims other than 64 and 128 take the edge route
    (the CUDA-core kernels at a padded head dim, columns past d masked):
    GQA 4:2, ragged lengths, against the twins; the backward twice,
    bitwise. Gradients with atol scaled by each tensor's largest
    magnitude."""
    q, do = (_rand(cuda_device, dtype, 2, sq, 4, d, seed=s) for s in (51, 54))
    k, v = (_rand(cuda_device, dtype, 2, sk, 2, d, seed=s) for s in (52, 53))
    assert not pt_flash._seg_fwd_tma_ok(2, 4, q, k, v)
    assert not pt_flash._seg_bwd_tma_ok(2, 4, 2, q, k, v, q, do)
    o, lse = pt_flash.flash_attention_with_lse(q, k, v, causal)
    ro, rlse = pt_flash.flash_attention_plain(q, k, v, causal)
    ro = ro.contiguous()
    got = pt_flash.flash_attention_bwd(q, k, v, ro, rlse, do, causal)
    again = pt_flash.flash_attention_bwd(q, k, v, ro, rlse, do, causal)
    want = pt_flash.flash_attention_bwd_plain(q, k, v, ro, rlse, do, causal)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    _check_fwd(o, lse, ro, rlse, tol)
    _check_grads(got, again, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_misaligned_bf16_takes_the_edge_route(cuda_device, d, causal):
    """#1 and #2 in bf16 with q, k, v, o and dO 2 bytes off alignment
    (TMA cannot map them) take the edge route instead of raising: each
    against the twin, the backward bitwise on repeat, and the two routes
    at the bf16 tier of each other."""
    sq, sk = 200, 200 if causal else 130
    q, do = (_rand(cuda_device, "bfloat16", 1, sq, 4, d, seed=s)
             for s in (61, 64))
    k, v = (_rand(cuda_device, "bfloat16", 1, sk, 2, d, seed=s)
            for s in (62, 63))
    ro, rlse = pt_flash.flash_attention_plain(q, k, v, causal)
    ro = ro.contiguous()
    aligned = (q, k, v, ro, do)
    shifted = tuple(_shifted(t) for t in aligned)
    assert pt_flash._seg_fwd_tma_ok(1, 4, *aligned[:3])
    assert not pt_flash._seg_fwd_tma_ok(1, 4, *shifted[:3])
    assert not pt_flash._seg_bwd_tma_ok(1, 4, 2, *shifted)
    want = pt_flash.flash_attention_bwd_plain(q, k, v, ro, rlse, do, causal)
    outs = []
    for q_, k_, v_, o_, do_ in (aligned, shifted):
        o, lse = pt_flash.flash_attention_with_lse(q_, k_, v_, causal)
        got = pt_flash.flash_attention_bwd(q_, k_, v_, o_, rlse, do_, causal)
        again = pt_flash.flash_attention_bwd(q_, k_, v_, o_, rlse, do_,
                                             causal)
        torch.cuda.synchronize()
        _check_fwd(o, lse, ro, rlse, BF16)
        _check_grads(got, again, want, BF16)
        outs.append((o, *got))
    for a, b in zip(*outs):
        ref = _np(b)
        np.testing.assert_allclose(_np(a), ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_segment_causal_forward_routes_by_alignment(cuda_device, d):
    """#3 in bf16 on #1's wgmma kernel under the segment mask where TMA
    maps q, k and v, on the edge route with the bases 2 bytes off: each
    against the twin at every descriptor the zig-zag ring issues at sp 2
    and 4 over a global 1000 (chunks no tile divides) and at every other
    kind (a query window straddling its split, rows and whole tiles with
    nothing visible), and the two routes at the bf16 tier of each other."""
    from paddle_tpu_torch.distributed.sequence_parallel import _zigzag_seg
    cases = [(2 * (1000 // (2 * sp)),) * 2
             + (_zigzag_seg(idx, src, 1000 // (2 * sp), sp),)
             for sp in (2, 4) for idx in range(sp) for src in range(sp)]
    for sq, sk, seg in cases + [(150, 130, [5, 190, 77, 0, 140, 61]),
                                (96, 96, [0, 48, 48, 20, 500, 96]),
                                (256, 256, [0, 384, 128, 128, 256, 128])]:
        q = _rand(cuda_device, "bfloat16", 2, sq, 4, d, seed=sq + 71)
        k, v = (_rand(cuda_device, "bfloat16", 2, sk, 2, d, seed=sk + s)
                for s in (72, 73))
        ro, rlse = pt_flash.flash_attention_seg_plain(q, k, v, seg)
        shifted = tuple(_shifted(t) for t in (q, k, v))
        assert pt_flash._seg_fwd_tma_ok(2, 4, q, k, v)
        assert not pt_flash._seg_fwd_tma_ok(2, 4, *shifted)
        outs = [pt_flash.flash_attention_seg_with_lse(*ts, seg)
                for ts in ((q, k, v), shifted)]
        again = pt_flash.flash_attention_seg_with_lse(q, k, v, seg)
        torch.cuda.synchronize()
        for o, lse in outs:
            _check_fwd(o, lse, ro, rlse, BF16)
        assert torch.equal(outs[0][0], again[0])
        np.testing.assert_allclose(_np(outs[0][0]), _np(outs[1][0]), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("d", [16, 96, 256])
def test_ragged_kernel_head_dims_match_twin(cuda_device, q_dtype, kv_dtype,
                                            d):
    """#8 at head dims other than 64 and 128 (padded to 64, 128 and 256;
    at 256 in fp32 a lane owns two 16-byte chunks of a row): against the
    twin, the pad row exactly 0."""
    args = _ragged_inputs(cuda_device, q_dtype, kv_dtype, d=d)
    out = pt_ragged.ragged_paged_attention(*args)
    ref = pt_ragged.ragged_paged_attention_plain(*args)
    torch.cuda.synchronize()
    tol = FP32 if q_dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    assert float(out[-1].abs().max()) == 0.0


@pytest.mark.cuda
def test_head_dims_outside_the_kernels_raise_on_the_card(cuda_device):
    """A head dim that is no multiple of 16, or above 256, raises on CUDA
    tensors naming the accepted set, before any launch (#1, #3, #8, #9
    and #10)."""
    from paddle_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    for d in (8, 72, 272):
        q = torch.zeros(1, 8, 2, d, device=cuda_device)
        with pytest.raises(ValueError, match="multiple of 16 in 16..256"):
            pt_flash.flash_attention_with_lse(q, q, q, True)
        with pytest.raises(ValueError, match="multiple of 16 in 16..256"):
            pt_flash.flash_attention_seg_with_lse(q, q, q,
                                                  [0, 8, 8, 0, 8, 8])
        args = _ragged_inputs(cuda_device, "float32", "float32", d=d)
        with pytest.raises(ValueError, match="multiple of 16 in 16..256"):
            pt_ragged.ragged_paged_attention(*args)
        q, kc, vc, tables, rows, valids, bs = args
        with pytest.raises(ValueError, match="multiple of 16 in 16..256"):
            pt_paged.paged_decode_attention(q[:3], kc, vc, tables, rows[:3],
                                            bs)
        i8 = torch.zeros(kc.shape, dtype=torch.int8, device=cuda_device)
        sc = torch.ones(kc.shape[:2], device=cuda_device)
        with pytest.raises(ValueError, match="multiple of 16 in 16..256"):
            pt_quant.ragged_paged_attention_quant(q, i8, i8, sc, sc, tables,
                                                  rows, valids, bs)
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


@pytest.mark.cuda
def test_llama_at_head_dim_96_on_the_card(cuda_device):
    """A tiny fp32 Llama with 4:2 heads of 96 (hidden 384, 2 layers) on
    the card against its own copy on the CPU twins: the forward's logits,
    one training step's loss and every parameter's gradient (rel L2
    within 1e-4: fp32 sums in another order), and the compiled engine's
    greedy streams (>= 90% of tokens equal: random weights sit near ties),
    with flash forward and backward launches = layers a pass and ragged
    launches = steps x layers."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.ops import kernels
    cfg = llama_tiny_config(hidden_size=384, num_attention_heads=4,
                            num_key_value_heads=2, num_hidden_layers=2,
                            intermediate_size=512, vocab_size=512,
                            max_position_embeddings=256)
    cpu = LlamaForCausalLM(cfg, seed=9, device="cpu")
    gpu = LlamaForCausalLM(cfg, seed=9)
    gpu.load_state_dict({k: v.to(cuda_device)
                         for k, v in cpu.state_dict().items()})
    ids = np.random.RandomState(3).randint(0, 512, size=(2, 70))
    res = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = model.device
        kernels.reset_launch_counts()
        x = torch.from_numpy(ids).to(dev)
        logits = model(x)
        loss, _ = model(x, labels=x)
        loss.backward()
        res[name] = (logits.detach().cpu(), float(loss.detach()),
                     [p.grad.cpu() for p in model.parameters()])
        counts = kernels.launch_counts()
        want = 2 * 2 if name == "cuda" else 0     # two passes x 2 layers
        assert counts["flash_attention_fwd"] == want, counts
        assert counts["flash_attention_bwd"] == want // 2, counts
        model.zero_grad(set_to_none=True)
    (lc, lossc, gc), (lg, lossg, gg_) = res["cpu"], res["cuda"]
    assert float((lg - lc).norm() / lc.norm()) <= 1e-4
    assert abs(lossg - lossc) <= 1e-4 * abs(lossc)
    for a, b in zip(gg_, gc):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 1e-4
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6] * 5, [2, 7, 1, 8], list(range(70))]
    outs = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        kernels.reset_launch_counts()
        eng = GenerationEngine(model, max_seqs=4, max_seq_len=128,
                               block_size=16)
        with torch.no_grad():
            outs[name] = eng.generate([GenerationRequest(i, p,
                                                         max_new_tokens=9)
                                       for i, p in enumerate(prompts)])
        counts = kernels.launch_counts()
        want = eng.stats["steps"] * 2 if name == "cuda" else 0
        assert counts["ragged_paged_attention"] == want, counts
        assert eng.cache.free_blocks == eng.cache.num_blocks
    same = sum(a == b for i in outs["cuda"] for a, b in
               zip(outs["cuda"][i], outs["cpu"][i]))
    assert same >= 0.9 * 27, outs


@pytest.mark.cuda
def test_fused_a2a_expert_mlp_odd_widths_on_one_rank(cuda_device):
    """#17 in bf16 at M and F that are no multiples of 8, and at aligned
    widths with x_send 2 bytes off alignment, on a world of one (no
    process group: x_send is its own slot): the CUDA-core kernel against
    the twin at the bf16 tier scaled by the twin's largest magnitude, a
    second launch bitwise, sentinel rows and rows past each count zero;
    the aligned call takes the wgmma route."""
    from paddle_tpu_torch.ops.kernels import async_collectives as pt_ac
    g = torch.Generator().manual_seed(81)
    bucket, e_local, c_pad = 96, 2, 64
    for m, ffn, shift in ((68, 100, False), (64, 37, False),
                          (64, 96, True), (64, 96, False)):
        x = (torch.randn(bucket, m, generator=g)).to(cuda_device,
                                                     torch.bfloat16)
        x = _shifted(x) if shift else x
        wg, wu = ((torch.randn(e_local, m, ffn, generator=g) * 0.1)
                  .to(cuda_device, torch.bfloat16) for _ in range(2))
        wd = (torch.randn(e_local, ffn, m, generator=g) * 0.1).to(
            cuda_device, torch.bfloat16)
        counts = torch.tensor([50, 0], dtype=torch.int32, device=cuda_device)
        inv = torch.full((e_local * c_pad,), bucket, dtype=torch.int32)
        inv[:50] = torch.randperm(bucket, generator=g)[:50].int()
        inv[10] = bucket                     # a sentinel inside the count
        inv = inv.to(cuda_device)
        kw = dict(group=None, chunks=1, bucket=bucket, c_pad=c_pad)
        assert pt_ac._fused_tma_ok(m, ffn, x, wg, wu, wd) == (
            m % 8 == 0 and ffn % 8 == 0 and not shift)
        y = pt_ac.fused_a2a_expert_mlp(x, counts, inv, wg, wu, wd, **kw)
        again = pt_ac.fused_a2a_expert_mlp(x, counts, inv, wg, wu, wd, **kw)
        want = pt_ac.fused_a2a_expert_mlp_plain(x, counts, inv, wg, wu, wd,
                                                **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, again)
        ref = _np(want)
        np.testing.assert_allclose(_np(y), ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
        assert not y[10].any() and not y[50:].any()


@pytest.mark.cuda
def test_ring_copy_kernel_is_bit_equal_to_copy(cuda_device):
    """#16's copy kernel (``ptt_ring_copy``, the hop's stage and pull) on
    two segments at once: 16-byte vectors with a tail the unrolled loop
    does not divide, and bytes where a base is off alignment; each
    destination bit for bit ``Tensor.copy_``'s."""
    from paddle_tpu_torch.ops.kernels import _launch
    stream = _launch.stream_of(cuda_device)
    g = torch.Generator().manual_seed(91)
    for n0, n1, off in ((16 << 20, (16 << 20) + 48, 0), (1000003, 4096, 1),
                        (16, 0, 0)):
        src = [torch.randint(0, 256, (n + 1,), generator=g,
                             dtype=torch.uint8).to(cuda_device)[off:off + n]
               for n in (n0, n1)]
        dst = [torch.empty(n + 1, dtype=torch.uint8,
                           device=cuda_device)[off:off + n]
               for n in (n0, n1)]
        segs = 2 if n1 else 1
        _launch.launch("ptt_ring_copy", src[0].data_ptr(), dst[0].data_ptr(),
                       n0, src[1].data_ptr(), dst[1].data_ptr(), n1, segs,
                       stream)
        torch.cuda.synchronize()
        for s_, d_ in zip(src[:segs], dst[:segs]):
            assert torch.equal(s_, d_)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
def test_kv_pages_copy_is_bit_equal_to_copy(cuda_device, chunks):
    """#18's kernel (``pages_copy``) on #16's streaming loop: sizes that
    are no multiple of 16 (a masked byte tail after the vectors), a 64 MiB
    segment, and a source or destination base off alignment (the byte
    loop throughout), in 1, 2, 3 and 7 pieces; each destination bit for
    bit ``Tensor.copy_``'s, the byte past it untouched, one launch a
    call."""
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    g = torch.Generator().manual_seed(92 + chunks)
    for n, s_off, d_off in ((64 << 20, 0, 0), ((16 << 20) + 53, 0, 0),
                            (1000003, 1, 0), (4099, 0, 3), (15, 0, 0)):
        src = torch.randint(0, 256, (n + 1,), generator=g,
                            dtype=torch.uint8).to(cuda_device)[s_off:s_off + n]
        buf = torch.zeros(n + 4, dtype=torch.uint8, device=cuda_device)
        dst = buf[d_off:d_off + n]
        want = torch.empty_like(dst).copy_(src)
        n0 = k18.launches
        k18.pages_copy(dst, src.data_ptr(), chunks)
        torch.cuda.synchronize()
        assert k18.launches - n0 == 1
        assert torch.equal(dst, want), (n, s_off, d_off)
        assert not buf[d_off + n:].any()


@pytest.mark.cuda
def test_ring_kv_rotate_matches_twin_between_ranks_on_one_card(cuda_device,
                                                                tmp_path):
    """#16's port: two spawned ranks share the card over gloo; each hop
    of the IPC copy kernel equals the twin's gloo ``ppermute`` bit for bit,
    with two launches a hop, across growing slots, both slot parities and
    a size the 16-byte vectors do not divide."""
    import _torch_cp_ranks
    from paddle_tpu_torch import distributed as pt_dist
    cases = [((1, 64, 2, 64), torch.bfloat16), ((1, 256, 4, 64), torch.float32),
             ((1, 64, 2, 64), torch.bfloat16), ((3, 5, 7), torch.bfloat16)]
    torch.save(cases, tmp_path / "hops.pt")
    pt_dist.spawn(_torch_cp_ranks.hop_run, (str(tmp_path),), nprocs=2,
                  timeout=300)
    for r in range(2):
        got = torch.load(tmp_path / f"hop{r}.pt")
        assert [g["equal"] for g in got] == [True] * len(cases), got
        assert all(g["moved"] and g["launches"] == 2 for g in got), got


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_tiled_a2a_matches_twin_between_ranks_on_one_card(cuda_device,
                                                          tmp_path, world):
    """#15's port: ranks share the card over gloo; each exchange of the
    IPC pull kernel equals the twin's gloo exchange bit for bit, with one
    launch an exchange, in bf16, int32 (the expert ids) and fp32, at a
    block size the 16-byte vectors do not divide, with a KV hop (#16)
    between exchanges on the same slots."""
    import _torch_ep_ranks
    from paddle_tpu_torch import distributed as pt_dist
    cases = [((64, 32), torch.bfloat16), ((256,), torch.int32),
             ((128, 16), torch.float32), ((12, 5, 3), torch.bfloat16),
             ((64, 32), torch.bfloat16)]
    torch.save(cases, tmp_path / "a2a.pt")
    pt_dist.spawn(_torch_ep_ranks.a2a_cuda_run, (str(tmp_path),),
                  nprocs=world, timeout=300)
    for r in range(world):
        got = torch.load(tmp_path / f"a2a{r}.pt")
        assert all(g["equal"] and g["hop_equal"] and g["moved"]
                   and g["launches"] == 1 for g in got), got


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_fused_a2a_expert_mlp_matches_twin_between_ranks_on_one_card(
        cuda_device, tmp_path, world):
    """#17's port on the path's own packed inputs (global gshard routing,
    each rank's rows packed per chunk): against its twin (the gloo exchange,
    the inv gather, the grouped-GEMM twins) at the op-harness tiers scaled
    by the twin's largest magnitude, fp32 and bf16, one and two chunks,
    ragged K/N edges, a capacity that drops (cf 1.0) and an expert no
    token routes to; against the TPU kernel's arithmetic (gate and up in
    fp32) within the same tiers; a second launch bitwise, one launch a
    call; in bf16 at the path's widths with c_pad an odd multiple of 64;
    and in bf16 at M 68 and F 100, which take the CUDA-core kernel."""
    import _torch_ep_ranks
    from paddle_tpu_torch import distributed as pt_dist
    cases = [dict(tokens=256, experts=8, hidden=64, ffn=96, cf=2.0,
                  chunks=1, dtype=torch.float32),
             dict(tokens=256, experts=8, hidden=64, ffn=96, cf=2.0,
                  chunks=2, dtype=torch.bfloat16),
             dict(tokens=256, experts=16, hidden=128, ffn=176, cf=1.0,
                  chunks=1, dtype=torch.bfloat16, empty_expert=3),
             # the path's widths (M 1024, F 704) at c_pad 192, an odd
             # multiple of 64: the last 128-row tile runs past each expert
             dict(tokens=256, experts=8, hidden=1024, ffn=704, cf=3.0,
                  chunks=1, dtype=torch.bfloat16),
             # M and F no multiples of 8: the CUDA-core kernel in bf16
             dict(tokens=256, experts=8, hidden=68, ffn=100, cf=2.0,
                  chunks=2, dtype=torch.bfloat16)]
    torch.save(cases, tmp_path / "fused.pt")
    pt_dist.spawn(_torch_ep_ranks.fused_cuda_run, (str(tmp_path),),
                  nprocs=world, timeout=300)
    empty = 0
    for r in range(world):
        got = torch.load(tmp_path / f"fused{r}.pt")
        for case, g in zip(cases, got):
            tol = 1e-5 if case["dtype"] == torch.float32 else 2e-2
            assert g["err"] <= tol and g["bitwise"] and g["launches"] == 2 \
                and g["live"] > 0 and g["tpu_gap"] <= tol, (case, g)
        empty += got[2]["empty"]
    assert empty >= 1      # the rank that owns expert 3 has it empty


@pytest.mark.cuda
def test_async_a2a_off_refuses_cuda_tensors(cuda_device):
    """``pallas_async_a2a=off`` names the collective exchange, which moves
    CPU tensors: on a CUDA tensor the exchange raises rather than staging
    through the host, and ``auto`` launches the kernel (a world of one)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    x = torch.arange(12., device=cuda_device).reshape(4, 3)
    flags.set_flags({"pallas_async_a2a": "off"})
    try:
        with pytest.raises(NotImplementedError, match="pallas_async_a2a=off"):
            coll.ragged_all_to_all(x)
    finally:
        flags.set_flags({"pallas_async_a2a": "auto"})
    before = hops.launches_a2a
    assert torch.equal(coll.ragged_all_to_all(x), x)
    assert hops.launches_a2a == before + 1


@pytest.mark.cuda
def test_kv_pages_remote_copy_matches_twin_between_ranks_on_one_card(
        cuda_device, tmp_path):
    """#18's port: two spawned ranks share the card over gloo; the pull
    kernel moves rank 0's pages to rank 1 bit for bit as its twin (a gloo
    ``ppermute``) does, one launch a call, in bf16, int8 and fp32, at sizes
    the 16-byte vectors do not divide; a float64 tensor is refused."""
    import _torch_fleet_ranks
    from paddle_tpu_torch import distributed as pt_dist
    pt_dist.spawn(_torch_fleet_ranks.remote_copy_cuda_run, (str(tmp_path),),
                  nprocs=2, timeout=300)
    for r in range(2):
        got = torch.load(tmp_path / f"copy{r}.pt")
        assert len(got) == 5 and all(
            g["equal_twin"] and g["equal_source"] and g["moved"]
            and g["launches"] == 1 for g in got), got


_FLEET_SPEC = {"model": "llama_tiny", "seed": 7, "device": "cuda",
               # head_dim 128, a width the ragged kernel takes
               "config": dict(num_hidden_layers=2, hidden_size=256,
                              intermediate_size=256, num_attention_heads=2,
                              num_key_value_heads=1, vocab_size=128,
                              max_position_embeddings=256,
                              dtype="bfloat16"),
               "engine": {"max_seqs": 4, "max_seq_len": 128,
                          "block_size": 16},
               "server": {}}


def _prefill_record(sup, prompt):
    """A prefill job on a spawned ``pf0`` and the wire record its export
    made (read through the router-side proxy)."""
    import time
    from paddle_tpu_torch.inference import GenerationRequest
    pf = sup.spawn("pf0", "prefill")
    got = []
    pf.submit_prefill(GenerationRequest("q", prompt, max_new_tokens=2),
                      lambda rec, h: got.append(rec))
    deadline = time.monotonic() + 60
    while not got:
        assert time.monotonic() < deadline and pf.alive, \
            f"no handoff record (host alive: {pf.alive})"
        pf.refresh()
        time.sleep(0.01)
    return pf, got[0]


@pytest.mark.cuda
def test_ipc_handoff_between_processes_equals_the_serialized_route(
        cuda_device, tmp_path):
    """A ``serve_host`` prefill process hands one record over each route
    to this process: device to device (the descriptor of its exported
    buffer, pulled with #18, two launches, the buffer released after) and
    as packed bytes. Installed into an engine here, the two give the same
    page bits, and the stream continues the same."""
    from paddle_tpu_torch.distributed.launch.master import HTTPMaster
    from paddle_tpu_torch.inference import (FleetSupervisor,
                                            GenerationEngine)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    model = LlamaForCausalLM(llama_tiny_config(**_FLEET_SPEC["config"]),
                             seed=7)
    prompt = list(range(3, 40))
    out = {}
    for route, flag in (("ipc", "1"), ("bytes", "0")):
        master = HTTPMaster()
        sup = FleetSupervisor(master.address, _FLEET_SPEC,
                              log_dir=str(tmp_path / route),
                              env={"FLAGS_use_pallas_kernels": flag,
                                   "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        try:
            pf, rec = _prefill_record(sup, prompt)
            assert ("ipc" in rec) == (route == "ipc")
            eng = GenerationEngine(model, **_FLEET_SPEC["engine"])
            n0 = k18.launches
            rec["max_new_tokens"] = 8
            req = eng.import_request(rec)
            launches = k18.launches - n0
            idx = torch.as_tensor(eng.cache.slot_mapping(
                req.slot, 0, len(prompt)).astype(np.int64), device="cuda")
            pages = [eng.cache.k.index_select(1, idx).cpu(),
                     eng.cache.v.index_select(1, idx).cpu()]
            while eng.num_active:
                eng.step()
            out[route] = (pages, launches, list(req.output_ids))
            ins = pf.introspect()
            assert ins["ipc_held"] == 0 and ins["free_blocks"] == \
                ins["num_blocks"], ins
        finally:
            sup.close()
            master.shutdown()
    assert out["ipc"][1] == 2 and out["bytes"][1] == 0
    assert all(torch.equal(a, b) for a, b in zip(out["ipc"][0],
                                                  out["bytes"][0]))
    assert out["ipc"][2] == out["bytes"][2]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16", "int8", "fp8", "hybrid"])
def test_export_gathers_straight_into_the_ipc_buffer(cuda_device, case):
    """A prefill engine given an ``IPCOutbox`` gathers its record into the
    exported buffer, and the descriptor names views that hold, bit for
    bit, the arrays the in-memory export gathers: pages, a quantized
    pool's scales, a hybrid's state planes."""
    from paddle_tpu_torch.inference import (GenerationEngine,
                                            GenerationRequest, kv_handoff)
    from paddle_tpu_torch.models import (HybridSSMForCausalLM,
                                         LlamaForCausalLM, llama_tiny_config,
                                         ssm_tiny_config)
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    if case == "hybrid":
        model = HybridSSMForCausalLM(ssm_tiny_config(
            hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=4, layer_pattern="SA", ssm_head_dim=32),
            seed=3)
    else:
        model = LlamaForCausalLM(llama_tiny_config(
            **_FLEET_SPEC["config"]), seed=7)
    eng = GenerationEngine(model, max_seqs=4, max_seq_len=128, block_size=16,
                           kv_quant=case if case in ("int8", "fp8") else None)
    assert eng.add_request(GenerationRequest("x", list(range(3, 44)),
                                             max_new_tokens=2))
    while not eng._requests["x"].output_ids:
        eng.step()
    plain = eng.export_request("x")
    want = [plain["k"], plain["v"]]
    if case in ("int8", "fp8"):
        want += [plain["k_scale"], plain["v_scale"]]
    for p in plain.get("ssm_state") or []:
        want += [p["conv"], p["ssm"]]
    outbox = kv_handoff.IPCOutbox(eng.cache.device)
    eng._handoff_outbox = outbox
    rec = eng.export_request("x")
    assert "k" not in rec and outbox.held == 1
    d = rec["ipc"]
    assert [s["shape"] for s in d["segments"]] == [list(t.shape)
                                                   for t in want]
    base = outbox._held[d["generation"]]["ptr"]
    for seg, t in zip(d["segments"], want):
        nbytes = t.numel() * t.element_size()
        got = k18.device_view(base + seg["offset"], nbytes, t.device)
        assert torch.equal(got, t.contiguous().reshape(-1).view(torch.uint8))
    assert outbox.release(d["generation"]) and outbox.held == 0


@pytest.mark.cuda
def test_a_dead_exporters_record_is_refused(cuda_device, tmp_path):
    """What a dead exporter's mapping reads, and what the route does about
    it: a mapping opened while the prefill process lived still reads the
    bytes it held after a SIGKILL (the driver keeps the memory while it is
    mapped), so reading proves nothing; the install asks the source first,
    gets no answer, and refuses with the slot freed."""
    import ctypes
    import signal
    from paddle_tpu_torch.distributed.launch.master import HTTPMaster
    from paddle_tpu_torch.inference import (FleetSupervisor,
                                            GenerationEngine, kv_handoff)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.ops.kernels import _launch
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    master = HTTPMaster()
    sup = FleetSupervisor(master.address, _FLEET_SPEC,
                          log_dir=str(tmp_path),
                          env={"FLAGS_use_pallas_kernels": "1"})
    try:
        _, rec = _prefill_record(sup, list(range(5, 30)))
        d = rec["ipc"]
        seg = d["segments"][0]
        ptr = ctypes.c_void_p()
        _launch.launch("ptt_ipc_open", 0, bytes.fromhex(d["handle"]),
                       ctypes.byref(ptr))
        nbytes = int(np.prod(seg["shape"])) * 2
        before = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        k18.pages_copy(before, ptr.value + seg["offset"])
        sup.kill("pf0", signal.SIGKILL)
        after = torch.empty_like(before)
        k18.pages_copy(after, ptr.value + seg["offset"])
        torch.cuda.synchronize()
        assert torch.equal(after, before)
        _launch.launch("ptt_ipc_close", 0, ptr.value)
        model = LlamaForCausalLM(llama_tiny_config(**_FLEET_SPEC["config"]),
                                 seed=7)
        eng = GenerationEngine(model, **_FLEET_SPEC["engine"])
        n0 = k18.launches
        with pytest.raises(kv_handoff.HandoffRefused):
            eng.import_request(rec)
        assert k18.launches == n0
        assert eng.cache.free_blocks == eng.cache.num_blocks
        assert eng.num_active == 0
    finally:
        sup.close()
        master.shutdown()


# ------------------------------------------------- the serving memory plane
def _plane_cache(dev, dtype, quant=None, host=1 << 24, num_blocks=6):
    from paddle_tpu_torch.inference.paged_cache import PagedKVCache
    return PagedKVCache(3, num_blocks, 16, 2, 64, 4, dtype=dtype,
                        device=dev, quant=quant, host_tier_bytes=host)


def _plane_fill(c, slot, n, seed):
    """Seeded rows written at the slot's first n positions of every
    layer (quantized on write for a quantized pool)."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.from_numpy(c.slot_mapping(slot, 0, n).astype(np.int64))
    for li in range(c.num_layers):
        k = torch.randn(n, 2, 64, generator=g).to(c.device)
        v = torch.randn(n, 2, 64, generator=g).to(c.device)
        c.write(li, k, v, rows.to(c.device))


def _plane_rows(c, slot, n):
    """The raw bytes of the slot's first n rows over every layer, pages and
    (quantized) scales."""
    idx = torch.from_numpy(c.slot_mapping(slot, 0, n).astype(
        np.int64)).to(c.device)
    out = []
    for t in c._planes():
        r = t.view(torch.uint8) if t.element_size() == 1 else t
        out.append(r.index_select(1, idx).cpu())
    return out


def _plane_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(
            x.view(torch.uint8) if x.element_size() != 1 else x,
            y.view(torch.uint8) if y.element_size() != 1 else y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, None),
                                         (torch.float32, None),
                                         (torch.float32, "int8"),
                                         (torch.float32, "fp8")])
def test_copy_block_on_the_card_is_bitwise(cuda_device, dtype, quant):
    """A copy-on-write copies a page and its scales over every layer bit
    for bit, with no host sync (it runs inside stream capture)."""
    c = _plane_cache(cuda_device, dtype, quant, host=None)
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 32)
    _plane_fill(c, s, 32, seed=1)
    c.register_prefix(s, list(range(32)), 32)
    want = _plane_rows(c, s, 32)
    shared = c._tables[s][1]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):       # a host sync here would raise
        assert c.cow_block(s, 1)
    graph.replay()
    torch.cuda.synchronize()
    assert c._tables[s][1] != shared
    _plane_equal(_plane_rows(c, s, 32), want)
    c.free_slot(s)
    c.clear_prefix()
    assert c.free_blocks == c.num_blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, None),
                                         (torch.float32, None),
                                         (torch.float32, "int8")])
def test_spill_and_restore_on_the_card_are_bitwise(cuda_device, dtype,
                                                   quant):
    """A parked slot's pages and a spilled prefix page leave through
    pinned host buffers and come back bit for bit, scales included."""
    c = _plane_cache(cuda_device, dtype, quant, num_blocks=4)
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 40)
    _plane_fill(c, s, 40, seed=2)
    want = _plane_rows(c, s, 40)
    assert c.spill_slot(s) == 3
    _, pages = c.slot_spill_pages(s)
    assert all(p.k.is_pinned() and p.v.is_pinned() for p in pages)
    assert (quant is None) == (pages[0].k_scale is None)
    # the freed blocks are written over before the restore
    o = c.allocate_slot()
    assert c.ensure_capacity(o, 64)
    _plane_fill(c, o, 64, seed=3)
    c.free_slot(o)
    assert c.restore_slot(s)
    _plane_equal(_plane_rows(c, s, 40), want)
    # a prefix page spilled under pressure comes back on adoption
    c.register_prefix(s, list(range(40)), 40)
    c.free_slot(s)
    t = c.allocate_slot()
    assert c.ensure_capacity(t, 64)      # spills both index entries
    assert c.prefix_spills == 2
    c.free_slot(t)
    u = c.allocate_slot()
    assert c.adopt_prefix(u, list(range(40))) == 32
    assert c.prefix_restores == 2
    _plane_equal(_plane_rows(c, u, 32), [w[:, :32] for w in want])
    c.free_slot(u)
    c.clear_prefix()
    assert c.free_blocks == c.num_blocks == c.available_blocks
    assert c.host_tier.free_blocks == c.host_tier.num_blocks


@pytest.mark.cuda
def test_staged_restore_is_read_only_after_its_event(cuda_device):
    """A staged restore copies on a side stream; the compute stream waits
    on its event before writing the pages, so a step right after reads the
    restored rows even when the side stream is held back."""
    c = _plane_cache(cuda_device, torch.float32, num_blocks=4)
    s = c.allocate_slot()
    assert c.ensure_capacity(s, 48)
    _plane_fill(c, s, 48, seed=4)
    want = _plane_rows(c, s, 48)
    assert c.spill_slot(s) == 3
    c.k.zero_()
    c.v.zero_()
    side = c._side_stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)          # hold the side stream
    staged = c.stage_restore(s)
    assert not staged.event.query()             # the copy is still queued
    assert c.restore_slot(s, staged=staged)
    _plane_equal(_plane_rows(c, s, 48), want)   # read on the compute stream
    c.free_slot(s)
    assert c.host_tier.free_blocks == c.host_tier.num_blocks


@pytest.mark.cuda
def test_serve_plane_engine_on_the_card(cuda_device):
    """A tiny fp32 Llama on the card: four drafts give the streams of
    none, a linked prefix the streams of a cold engine (over full-width
    and over int8 pages), and a parked and
    restored request (staged and inline) the streams of an untiered run;
    every pool drains clean."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    model = LlamaForCausalLM(llama_tiny_config(
        num_hidden_layers=2, hidden_size=128, intermediate_size=256,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128),
        seed=7).eval()
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 128, n).tolist() for n in (9, 40, 17)]
    kw = dict(max_seqs=4, max_seq_len=128, block_size=16, mode="compiled")

    def run(**opts):
        eng = GenerationEngine(model, **kw, **opts)
        out = eng.generate([GenerationRequest(i, p, max_new_tokens=16)
                            for i, p in enumerate(prompts)])
        return eng, out
    _, base = run()
    eng, out = run(spec_tokens=4)
    assert out == base and eng.stats["spec_drafted"] > 0
    assert eng.cache.free_blocks == eng.cache.num_blocks
    eng, out = run(prefix_cache=True)
    again = eng.generate([GenerationRequest(10 + i, p, max_new_tokens=16)
                          for i, p in enumerate(prompts)])
    assert [again[10 + i] for i in range(3)] == [base[i] for i in range(3)]
    assert eng.stats["prefix_hit_tokens"] > 0
    eng.release_prefix_cache()
    assert eng.cache.free_blocks == eng.cache.num_blocks
    # int8 pages: #10 reads linked pages and their scales
    _, qbase = run(kv_quant="int8")
    eng, _ = run(kv_quant="int8", prefix_cache=True)
    again = eng.generate([GenerationRequest(10 + i, p, max_new_tokens=16)
                          for i, p in enumerate(prompts)])
    assert [again[10 + i] for i in range(3)] == [qbase[i] for i in range(3)]
    assert eng.stats["prefix_hit_tokens"] > 0
    eng.release_prefix_cache()
    assert eng.cache.free_blocks == eng.cache.num_blocks
    for ahead in (True, False):
        eng = GenerationEngine(model, host_tier=True, host_tier_bytes=1 << 24,
                               restore_ahead=ahead, **kw)
        for i, p in enumerate(prompts):
            assert eng.add_request(GenerationRequest(i, p,
                                                     max_new_tokens=16))
        for _ in range(6):
            eng.step()
        victim = eng._requests[1]
        victim.paused = True
        assert eng.spill_paused() > 0
        for _ in range(3):
            eng.step()
        victim.paused = False
        got = {}
        while eng._requests:
            eng.step()
            got.update({r.request_id: r.output_ids
                        for r in eng.reap_finished()})
        assert got == base
        assert eng.cache.slot_restores > 0
        assert eng.cache.free_blocks == eng.cache.num_blocks


# ------------------------------------------- the MoE layer's other routes
def _round_robin_gate(d, e):
    """A gate with only the dense ``route`` (the reference test's)."""
    from paddle_tpu_torch.incubate.distributed.models import moe

    class RoundRobin(moe.BaseGate):
        top_k = 1

        def route(self, scores, capacity):
            n, ne = scores.shape
            rows = torch.arange(n, device=scores.device)
            combine = torch.zeros((n, ne, capacity), dtype=scores.dtype,
                                  device=scores.device)
            combine[rows, rows % ne, (rows // ne).clamp(
                max=capacity - 1)] = 1.0
            return combine, combine > 0, torch.zeros(
                (), dtype=scores.dtype, device=scores.device)
    return RoundRobin(d, e, device="cpu")


def _moe_layer(expert, gate="gshard", cf=1.0, recompute=0, d=64, e=8):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.models import llama as L
    torch.manual_seed(90)
    if expert == "linear":
        experts = [pnn.Linear(d, d, bias=True) for _ in range(e)]
        for x in experts:
            torch.nn.init.normal_(x.bias, std=0.5)
    else:
        cfg = L.LlamaConfig(hidden_size=d, intermediate_size=96)
        init = L._Init(cfg, torch.device("cpu"),
                       torch.Generator().manual_seed(91))
        experts = [L.LlamaMLP(cfg, init) for _ in range(e)]
    if gate == "round-robin":
        gate = _round_robin_gate(d, e)
    return moe.MoELayer(d, experts, gate=gate, capacity_factor=cf,
                        recompute_interval=recompute)


def _moe_grads(layer, x):
    """y and the gradients of x and every parameter of ``(y*y).sum() +
    aux``."""
    layer.zero_grad(set_to_none=True)
    x = x.detach().requires_grad_(True)
    y = layer(x)
    (y.float().square().sum() + layer.gate.get_loss()).backward()
    return [y.detach(), x.grad] + [
        torch.zeros_like(p) if p.grad is None else p.grad
        for p in layer.parameters()]


def _moe_card_vs_cpu(layer, x, tol, launched=0):
    """The layer on the card against a copy on the CPU; the grouped GEMMs
    launched ``launched`` times a forward and backward."""
    import copy
    cpu = _moe_grads(layer, x)
    layer.gate._loss = None
    card = copy.deepcopy(layer).to("cuda")
    before = (pt_gg.launches, pt_gg.launches_gmm2, pt_gg.launches_tgmm)
    got = _moe_grads(card, x.to("cuda"))
    torch.cuda.synchronize()
    after = (pt_gg.launches, pt_gg.launches_gmm2, pt_gg.launches_tgmm)
    assert sum(after) - sum(before) == launched, (before, after)
    for a, b in zip(got, cpu):
        _gg_close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("expert", ["swiglu", "linear"])
def test_moe_index_form_on_the_card_matches_the_cpu(cuda_device, expert):
    """``moe_grouped_gemm=off`` (SwiGLU experts) and bias ``Linear``
    experts: the scatter into ``[E, C, M]``, the vmapped experts and the
    gather on the card against the CPU, fp32, cf 1.0 (drops), output and
    every gradient; no grouped GEMM runs."""
    from paddle_tpu_torch import flags
    layer = _moe_layer(expert)
    x = torch.randn(256, 64, generator=torch.Generator().manual_seed(92))
    flags.set_flags({"moe_grouped_gemm": "off"})
    try:
        _moe_card_vs_cpu(layer, x, dict(rtol=1e-5, atol=1e-5))
    finally:
        flags.set_flags({"moe_grouped_gemm": "auto"})


@pytest.mark.cuda
def test_moe_dense_route_on_the_card_matches_the_cpu(cuda_device):
    """A gate with only the dense ``route``: the ``[N, E, C]`` einsums and
    the vmapped experts on the card against the CPU."""
    layer = _moe_layer("linear", gate="round-robin", cf=2.0)
    x = torch.randn(256, 64, generator=torch.Generator().manual_seed(93))
    _moe_card_vs_cpu(layer, x, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "off"])
def test_moe_recompute_on_the_card_is_bitwise(cuda_device, mode):
    """``recompute_interval=1`` in the grouped arm (the kernels replayed in
    the backward: gmm2 and the down gmm twice) and the index form, bf16:
    output and every gradient bit for bit those of
    ``recompute_interval=0``."""
    from paddle_tpu_torch import flags
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(94)) \
        .to(cuda_device, torch.bfloat16)
    flags.set_flags({"moe_grouped_gemm": mode})
    try:
        runs, gmm2 = [], []
        for recompute in (0, 1):
            layer = _moe_layer("swiglu", recompute=recompute).to(
                cuda_device, torch.bfloat16)
            before = pt_gg.launches_gmm2
            runs.append(_moe_grads(layer, x))
            torch.cuda.synchronize()
            gmm2.append(pt_gg.launches_gmm2 - before)
    finally:
        flags.set_flags({"moe_grouped_gemm": "auto"})
    assert gmm2 == ([1, 2] if mode == "auto" else [0, 0]), gmm2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_fp16_experts_take_the_index_form_on_the_card(cuda_device):
    """fp16 experts, which the grouped kernels refuse: the layer takes the
    index form before any launch, with one warning naming the dtype, and
    matches the same layer in fp32 on the card within the bf16 tier."""
    import warnings
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    layer = _moe_layer("swiglu").to(cuda_device)
    x = torch.randn(256, 64, generator=torch.Generator().manual_seed(95)) \
        .to(cuda_device)
    want = _moe_grads(layer, x)
    layer.gate._loss = None
    half = layer.half()
    moe_layer._warned_fallbacks.clear()
    before = (pt_gg.launches, pt_gg.launches_gmm2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = _moe_grads(half, x.half())
        _moe_grads(half, x.half())
    torch.cuda.synchronize()
    assert (pt_gg.launches, pt_gg.launches_gmm2) == before
    msgs = [str(w.message) for w in caught
            if "moe_grouped_gemm" in str(w.message)]
    assert len(msgs) == 1 and "torch.float16" in msgs[0], msgs
    _gg_close(got[0], want[0], BF16)


# --------------------------------------------- jit.to_static: CUDA graphs
def _jit_trainer(dev, recompute=False, seed=0):
    """A 2-layer bf16 Llama (hidden 512, ffn 1024, 4:2 heads of 128,
    vocab 4096) under the Llama-2 recipe: AdamW over fp32 masters,
    global-norm clip 1.0, warmup 3 into cosine 12, stepped in the step."""
    from paddle_tpu_torch import optimizer as pt_opt
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    cfg = LlamaConfig(vocab_size=4096, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512,
                      dtype="bfloat16", recompute=recompute)
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    lr = pt_opt.lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=12),
                            warmup_steps=3, start_lr=0.0, end_lr=3e-4)
    opt = pt_opt.AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                       epsilon=1e-5, weight_decay=0.1, multi_precision=True,
                       parameters=model.parameters(),
                       grad_clip=ClipGradByGlobalNorm(1.0))

    def step(ids):
        loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.detach()
    return model, opt, step


def _jit_ids(dev, shape=(2, 256)):
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, 4096, shape, generator=g,
                         dtype=torch.int32).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [False, True])
def test_to_static_captures_the_train_step_bitwise(cuda_device, recompute):
    """The step captured into one graph (first call eager, second
    captured, then replays) against the same step eager, from the same
    seed: 5 losses, every parameter, master and moment, the step count
    and the LR tensor bit for bit; with ``recompute`` the non-reentrant
    checkpoint's replay runs inside the captured backward."""
    from paddle_tpu_torch import jit as pt_jit
    from paddle_tpu_torch.ops import kernels
    ids = _jit_ids(cuda_device)
    arms = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    for static in (True, False):
        model, opt, step = _jit_trainer(cuda_device, recompute)
        f = pt_jit.to_static(step) if static else step
        kernels.reset_launch_counts()
        losses, lrs = [], []
        for _ in range(5):
            losses.append(f(ids))
            lrs.append(opt._lr_tensor.clone())
        torch.cuda.synchronize()
        arms.append(dict(losses=losses, lrs=lrs,
                         counts=kernels.launch_counts(),
                         params=[p.detach().clone()
                                 for p in model.parameters()],
                         state=[t.clone() for t in opt._state_tensors()]))
        if static:
            prog, = f.concrete_programs()
            assert prog.captured and prog.reason is None
            assert prog.memory_analysis().temp_size_in_bytes > 0
    torch.use_deterministic_algorithms(False)
    cap, eag = arms
    for key in ("losses", "lrs", "params", "state"):
        assert len(cap[key]) == len(eag[key])
        for i, (a, b) in enumerate(zip(cap[key], eag[key])):
            assert torch.equal(a, b), (key, i)
    assert cap["counts"] == eag["counts"]
    assert cap["counts"]["rms_norm_fwd"] > 0


@pytest.mark.cuda
def test_to_static_stages_the_lr_when_the_host_runs_ahead(cuda_device):
    """The host queues 40 replays ahead of the card (a long matmul chain
    a step) and synchronizes once: each replay read its own step's LR."""
    from paddle_tpu_torch import jit as pt_jit
    from paddle_tpu_torch import optimizer as pt_opt
    w = torch.nn.Parameter(torch.randn(1024, 1024, device=cuda_device) / 32)
    sched = pt_opt.lr.LambdaDecay(1.0, lambda e: 1.0 / (1 + e))
    opt = pt_opt.SGD(learning_rate=sched, parameters=[w])
    a = torch.randn(1024, 1024, device=cuda_device)

    @pt_jit.to_static
    def step(x):
        y = x
        for _ in range(24):
            y = torch.tanh(y @ w)
        y.sum().backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return opt._lr_tensor.clone()

    torch.cuda.synchronize()
    outs = [step(a) for _ in range(40)]
    torch.cuda.synchronize()
    want = [float(np.float32(1.0 / (1 + e))) for e in range(1, 41)]
    assert [float(o) for o in outs] == want
    assert sched.last_epoch == 40


@pytest.mark.cuda
def test_to_static_counts_replayed_launches(cuda_device):
    """The wrappers' counters count a replayed launch as an issued one."""
    from paddle_tpu_torch import jit as pt_jit
    from paddle_tpu_torch.ops import kernels
    x = torch.randn(64, 512, device=cuda_device, dtype=torch.bfloat16)
    w = torch.ones(512, device=cuda_device)

    @pt_jit.to_static
    def f(t):
        return pt_rms.rms_norm(pt_rms.rms_norm(t, w, 1e-6), w, 1e-6)

    kernels.reset_launch_counts()
    outs = [f(x) for _ in range(5)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rms_norm_fwd"] == 10
    assert f.concrete_programs()[0].captured
    assert all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
def test_to_static_host_sync_runs_eagerly(cuda_device):
    """A step that reads a device value on the host cannot be captured:
    the capture ends, the host state it advanced (a scheduler's epoch) is
    put back, one warning names the error, the step runs eagerly from then
    on and the process goes on."""
    import warnings
    from paddle_tpu_torch import jit as pt_jit
    from paddle_tpu_torch import optimizer as pt_opt
    x = torch.arange(6., device=cuda_device)
    sched = pt_opt.lr.StepDecay(1.0, step_size=1, gamma=0.5)
    opt = pt_opt.SGD(learning_rate=sched,
                     parameters=[torch.nn.Parameter(x.clone())])

    @pt_jit.to_static
    def f(t):
        sched.step()            # a host effect the failed capture undoes
        y = t * opt._lr_tensor
        return y * float(y.sum())

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        outs = [f(x) for _ in range(4)]
    torch.cuda.synchronize()
    assert sum("cannot be captured" in str(w.message) for w in rec) == 1
    prog, = f.concrete_programs()
    assert not prog.captured and prog.reason
    assert sched.last_epoch == 4
    for i, o in enumerate(outs):
        lr = 0.5 ** (i + 1)
        assert torch.equal(o, (x * lr) * float((x * lr).sum()))
    assert float((x + 1).sum()) == 21.0
    # and the caching allocator still returns what it frees
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    big = torch.empty(1 << 30, dtype=torch.uint8, device=cuda_device)
    del big
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= before


# ----------------------------------- the captured serving step (A.5)
def _serve_model(case, dev):
    """The tiny model of a captured-serving case, on the card, from a
    seed, and its engine options."""
    from paddle_tpu_torch.models import (HybridSSMForCausalLM, LlamaConfig,
                                         LlamaForCausalLM, llama_tiny_config,
                                         ssm_tiny_config)
    if case == "hybrid":
        cfg = ssm_tiny_config(hidden_size=256, num_attention_heads=4,
                              num_key_value_heads=2, num_hidden_layers=4,
                              layer_pattern="SA", ssm_head_dim=32)
        return HybridSSMForCausalLM(cfg, device=dev, seed=3).eval(), {}
    if case == "moe":
        cfg = LlamaConfig(vocab_size=512, hidden_size=128,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=8, num_key_value_heads=8,
                          max_position_embeddings=256, moe_num_experts=4,
                          moe_capacity_factor=2.0, dtype="bfloat16")
        return LlamaForCausalLM(cfg, device=dev, seed=5).eval(), {}
    dtype = "bfloat16" if case == "dense_bf16" else "float32"
    cfg = llama_tiny_config(num_hidden_layers=2, hidden_size=128,
                            intermediate_size=256, num_attention_heads=4,
                            num_key_value_heads=2, vocab_size=512,
                            dtype=dtype)
    opts = {"int8": dict(kv_quant="int8"),
            "weight_int8": dict(kv_quant="int8", weight_quant=True),
            "spec_prefix_tiered": dict(spec_tokens=4, prefix_cache=True,
                                       host_tier=True,
                                       host_tier_bytes=1 << 24)}
    return LlamaForCausalLM(cfg, device=dev, seed=7).eval(), \
        opts.get(case, {})


def _serve_drive(eng, vocab, tiered):
    """Two waves of mixed greedy and seeded requests (prompts of 5..70
    tokens, the second wave sharing the first's prompts), and with
    ``tiered`` a request paused, parked in the host tier and resumed
    mid-wave; returns every stream."""
    from paddle_tpu_torch.inference import GenerationRequest
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, vocab, n).tolist() for n in (5, 40, 17, 70)]
    got = {}
    for wave in range(2):
        for i, p in enumerate(prompts):
            kw = dict(temperature=0.8, top_p=0.95, seed=100 + i) \
                if i % 2 else {}
            # request 1 outlives the pause: it is the one parked
            assert eng.add_request(GenerationRequest(
                (wave, i), p, max_new_tokens=40 if i == 1 else 14, **kw))
        for k in range(200):
            if not eng.num_active:
                break
            if tiered and k == 4:
                victim = eng._requests[(wave, 1)]
                victim.paused = True
                assert eng.spill_paused() > 0
            if tiered and k == 8:
                victim.paused = False
            eng.step()
            got.update({r.request_id: (r.output_ids, r.finish_reason)
                        for r in eng.reap_finished()})
    assert len(got) == 2 * len(prompts)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense_bf16", "int8", "weight_int8", "moe",
                                  "hybrid", "spec_prefix_tiered"])
def test_captured_engine_is_bitwise_its_eager_arm(cuda_device, case):
    """The compiled engine with its step captured by bucket signature
    (each signature's first call eager, its second captured, then
    replays) against the same engine with ``enable_to_static(False)``:
    every stream, finish reason and launch count equal, every program
    captured, no capture warning, every page back after the drain."""
    import warnings
    from paddle_tpu_torch import jit as pt_jit
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.ops import kernels
    model, opts = _serve_model(case, cuda_device)
    kw = dict(max_seqs=4, max_seq_len=256, block_size=16, mode="compiled",
              **opts)
    arms = {}
    for static in (True, False):
        pt_jit.enable_to_static(static)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                kernels.reset_launch_counts()
                eng = GenerationEngine(model, **kw)
                out = _serve_drive(eng, model.config.vocab_size,
                                   case == "spec_prefix_tiered")
                torch.cuda.synchronize()
        finally:
            pt_jit.enable_to_static(True)
        eng.release_prefix_cache()
        assert eng.cache.free_blocks == eng.cache.num_blocks
        assert not [w for w in caught if "cannot be captured" in
                    str(w.message)]
        arms[static] = (out, kernels.launch_counts(), eng.capture_stats(),
                        eng.decode_signatures())
    (cap, cap_counts, stats, sigs), (eag, eag_counts, eag_stats, esigs) = \
        arms[True], arms[False]
    assert cap == eag
    assert cap_counts == eag_counts
    assert sigs == esigs and eag_stats["programs"] == 0
    assert stats["captured"] >= 3 and not stats["eager"], stats
    assert stats["programs"] == sigs
    attn = ("ragged_paged_attention_quant" if "int8" in case
            else "ragged_paged_attention")
    assert cap_counts[attn] > 0


@pytest.mark.cuda
def test_captured_engine_shares_one_graph_pool(cuda_device):
    """All programs of an engine capture into one pool: after four or
    more captured signatures the pool is under twice one step's peak
    temporaries (a bf16 model widens its 32000 x 1024 LM head to fp32 in
    every step, 131 MB, so a pool per program would hold that once a
    signature), and it goes back to the device when the engine is
    dropped."""
    import gc
    from paddle_tpu_torch import jit as pt_jit
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=32000, hidden_size=1024,
                      intermediate_size=2048, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=4,
                      max_position_embeddings=512, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=cuda_device, seed=1).eval()
    kw = dict(max_seqs=4, max_seq_len=512, block_size=16, mode="compiled")
    # one step's peak: the eager arm's largest step over the engine's
    # own memory
    pt_jit.enable_to_static(False)
    try:
        eng = GenerationEngine(model, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _serve_drive(eng, cfg.vocab_size, False)
        step_peak = torch.cuda.max_memory_allocated() - base
    finally:
        pt_jit.enable_to_static(True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    eng = GenerationEngine(model, **kw)
    _serve_drive(eng, cfg.vocab_size, False)
    stats = eng.capture_stats()
    assert stats["captured"] >= 4, stats
    assert step_peak > 131e6, step_peak
    assert 0 < stats["pool_bytes"] < 2 * step_peak, (stats, step_peak)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    assert after <= before + (32 << 20), (before, after, stats)


@pytest.mark.cuda
def test_captured_server_steps_beside_a_handoff_install(cuda_device):
    """A server's engine captures and replays its step in one thread while
    another thread installs handoff records into a second engine on the
    same card, again and again: no capture fails, every program is
    captured, and the served streams are those of the server alone."""
    import threading
    import warnings
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    from paddle_tpu_torch.inference.server import GenerationServer
    model, _ = _serve_model("dense_fp32", cuda_device)
    kw = dict(max_seqs=4, max_seq_len=256, block_size=16, mode="compiled")
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 512, n).tolist() for n in (9, 33, 21, 60)]

    def serve_all():
        srv = GenerationServer(GenerationEngine(model, **kw))
        handles = [srv.submit(GenerationRequest(i, p, max_new_tokens=24))
                   for i, p in enumerate(prompts)]
        assert srv.run_until_idle()
        return srv.engine, [h.output_ids for h in handles]

    _, alone = serve_all()
    src = GenerationEngine(model, **kw)
    assert src.add_request(GenerationRequest("h", prompts[1],
                                             max_new_tokens=2))
    while not src._requests["h"].output_ids:
        src.step()
    record = src.export_request("h")
    dst = GenerationEngine(model, **kw)
    stop, installs, errors = threading.Event(), [0], []

    def install_loop():
        try:
            while not stop.is_set():
                req = dst.import_request(dict(record))
                assert req is not None
                dst.evict(req.request_id, "done")
                dst.reap_finished()
                installs[0] += 1
        except Exception as e:      # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=install_loop)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t.start()
        try:
            eng, beside = serve_all()
        finally:
            stop.set()
            t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert installs[0] > 0
    assert not [w for w in caught if "cannot be captured" in str(w.message)]
    stats = eng.capture_stats()
    assert stats["captured"] >= 2 and not stats["eager"], stats
    assert beside == alone
    assert dst.cache.free_blocks == dst.cache.num_blocks


@pytest.mark.cuda
def test_no_collection_runs_inside_a_capture(cuda_device):
    """Engines dropped into reference cycles hold graphs that only the
    collector frees; another engine then serves, capturing its step, with
    a full collection every 700 allocations. No collection may run while a
    graph is being captured (one that frees a graph fails the capture
    inside CUDA and leaves the pool unable to begin the next), no capture
    fails, and the streams are the eager arm's."""
    import gc
    import warnings
    from paddle_tpu_torch import jit as pt_jit
    from paddle_tpu_torch.inference import GenerationEngine
    model, _ = _serve_model("dense_fp32", cuda_device)
    kw = dict(max_seqs=4, max_seq_len=256, block_size=16, mode="compiled")
    pt_jit.enable_to_static(False)
    try:
        want = _serve_drive(GenerationEngine(model, **kw), 512, False)
    finally:
        pt_jit.enable_to_static(True)
    for _ in range(2):
        dead = GenerationEngine(model, **kw)
        _serve_drive(dead, 512, False)
        dead.cycle = dead           # freed by the collector alone
    del dead
    inside = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            inside.append(info["generation"])
    old = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(700, 1, 1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = GenerationEngine(model, **kw)
            got = _serve_drive(eng, 512, False)
    finally:
        gc.set_threshold(*old)
        gc.callbacks.remove(watch)
    torch.cuda.synchronize()
    assert not inside, inside
    assert not [w for w in caught if "cannot be captured" in str(w.message)]
    stats = eng.capture_stats()
    assert stats["captured"] >= 3 and not stats["eager"], stats
    assert got == want
