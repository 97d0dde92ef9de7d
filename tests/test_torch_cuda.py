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
    another order) of a width that is no multiple of the vector; bitwise
    repeat."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype,c_pad", [
    ("bfloat16", "bfloat16", 128), ("float32", "float32", 128),
    ("float32", "bfloat16", 128), ("bfloat16", "bfloat16", 192)])
def test_gmm_and_gmm2_kernels_match_twins(cuda_device, x_dtype, w_dtype,
                                          c_pad):
    """gmm, gmm2 and the transposed gmm of the backward: the twin's values
    (zeros past each count included) at the tier of x's dtype, and a
    second launch gives the same bits; every output is exactly zero past
    each count."""
    x, w, counts = _gg_inputs(cuda_device, x_dtype, w_dtype, c_pad=c_pad)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tgmm_kernel_matches_twin_bitwise_on_repeat(cuda_device, dtype):
    """dw fp32 over each expert's live rows only: the rows past a count
    hold noise here, which neither the kernel nor the twin may read."""
    x, _, counts = _gg_inputs(cuda_device, dtype, dtype)
    x = x + _rand(cuda_device, dtype, *x.shape, seed=60)
    dy = _rand(cuda_device, dtype, x.shape[0], 200, seed=61)
    dw = pt_gg.tgmm(x, dy, counts)
    assert dw.dtype == torch.float32 and dw.shape == (4, 88, 200)
    assert torch.equal(dw, pt_gg.tgmm(x, dy, counts))
    assert float(dw[1].abs().max()) == 0.0          # the empty expert
    ref = _np(pt_gg.tgmm_plain(x, dy, counts))
    np.testing.assert_allclose(_np(dw), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


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
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,seg", [
    (200, 200, [0, 300, 100, 0, 300, 100]),     # a ring's t=0 step
    (200, 200, [100, 200, 100, 0, 300, 100]),   # KV from an earlier rank
    (150, 130, [5, 190, 77, 0, 140, 61]),       # straddling splits
    (96, 96, [0, 48, 48, 20, 500, 96])])        # rows with nothing visible
def test_segment_causal_kernels_match_twins(cuda_device, dtype, d, sq, sk,
                                            seg):
    """#3 and #4 against their twins: GQA 4:2, splits no tile divides, a
    query tile that straddles its split, rows that see no column (o = 0,
    lse = -inf); the backward twice, bitwise. lse at atol 1e-5, the
    gradients with atol scaled by each tensor's largest magnitude."""
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
    call; and in bf16 at the path's widths with c_pad an odd multiple of
    64."""
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
                  chunks=1, dtype=torch.bfloat16)]
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
