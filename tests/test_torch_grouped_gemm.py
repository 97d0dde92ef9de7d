"""The port's grouped GEMMs (plain twins on the CPU) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
``tests/test_grouped_gemm.py`` runs them.

Inputs are made with numpy from a seed and handed to both sides. Buffers
keep the kernels' contract: rows past each expert's count are zero, and so
are the cotangents there. Tolerances follow ``tests/op_harness.py``: fp32
rtol 1e-5 / atol 1e-6, bf16 2e-2; an fp32 value that is a sum of products
is held at atol 1e-6 times the largest magnitude of its tensor, since each
element carries the rounding of its terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jax_flags
from paddle_tpu.ops.pallas import grouped_gemm as jgg
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import grouped_gemm as pgg
from paddle_tpu_torch.weights import to_torch

COUNTS = [7, 0, 16, 3]          # uneven, one empty, one full
C_PAD, K = 16, 16
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def _grouped_on():
    """``moe_grouped_gemm=on`` on the JAX side, as the reference's own
    grouped-GEMM tests set it, restored after."""
    old = jax_flags.flag("moe_grouped_gemm")
    jax_flags.set_flags({"moe_grouped_gemm": "on"})
    yield
    jax_flags.set_flags({"moe_grouped_gemm": old})


def _buf(rs, width, dtype, counts=COUNTS, c_pad=C_PAD):
    """Expert-major ``[E*c_pad, width]`` with zero rows past each count, as
    (jax array, torch tensor) holding the same bits."""
    out = np.zeros((len(counts) * c_pad, width), np.float32)
    for e, c in enumerate(counts):
        out[e * c_pad:e * c_pad + c] = rs.randn(c, width)
    j = jnp.asarray(out, dtype)
    return j, to_torch(np.asarray(j))


def _rand(rs, shape, dtype, scale=1.0):
    j = jnp.asarray(rs.randn(*shape) * scale, dtype)
    return j, to_torch(np.asarray(j))


def _close(got, want, dtype, scaled=True):
    g = got.detach().float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    tol = dict(TOL[dtype])
    if scaled:
        tol["atol"] *= max(np.abs(w).max(), 1.0)
    np.testing.assert_allclose(g, w, **tol)


def _counts():
    return (jnp.asarray(COUNTS, jnp.int32),
            torch.tensor(COUNTS, dtype=torch.int32))


@pytest.mark.parametrize("n", [24, 88])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_forward_and_grads_match_jax(dtype, n):
    """Forward, dx (the transposed gmm) and dw (tgmm) for N = 24 and 88,
    neither a multiple of 128 (the reference pads them, the port masks)."""
    rs = np.random.RandomState(0)
    jx, px = _buf(rs, K, dtype)
    jw, pw = _rand(rs, (4, K, n), dtype, 0.5)
    jdy, pdy = _buf(rs, n, dtype)
    jc, pc = _counts()
    jy, vjp = jax.vjp(lambda x, w: jgg.gmm(x, w, jc, block_m=8), jx, jw)
    jdx, jdw = vjp(jdy)
    px.requires_grad_(True)
    pw.requires_grad_(True)
    kernels.reset_launch_counts()
    py = pgg.GmmFunction.apply(px, pw, pc)
    pdx, pdw = torch.autograd.grad(py, (px, pw), pdy)
    assert py.dtype == px.dtype and pdw.dtype == pw.dtype
    for got, want in ((py, jy), (pdx, jdx), (pdw, jdw)):
        _close(got, want, dtype)
    assert float(py[16:32].detach().abs().max()) == 0.0   # empty expert
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm2_forward_and_grads_match_jax(dtype):
    """Both outputs, and dx as the sum of two transposed gmm results in
    x's dtype, dw1 and dw2 from tgmm."""
    rs = np.random.RandomState(1)
    n = 88
    jx, px = _buf(rs, K, dtype)
    jw1, pw1 = _rand(rs, (4, K, n), dtype, 0.5)
    jw2, pw2 = _rand(rs, (4, K, n), dtype, 0.5)
    jd1, pd1 = _buf(rs, n, dtype)
    jd2, pd2 = _buf(rs, n, dtype)
    jc, pc = _counts()
    (jy1, jy2), vjp = jax.vjp(
        lambda x, a, b: jgg.gmm2(x, a, b, jc, block_m=8), jx, jw1, jw2)
    jgrads = vjp((jd1, jd2))
    ins = [t.requires_grad_(True) for t in (px, pw1, pw2)]
    py1, py2 = pgg.Gmm2Function.apply(*ins, pc)
    pgrads = torch.autograd.grad((py1, py2), ins, (pd1, pd2))
    _close(py1, jy1, dtype)
    _close(py2, jy2, dtype)
    for got, want in zip(pgrads, jgrads):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tgmm_matches_jax(dtype):
    """dw fp32 over uneven counts with an empty expert, K=16 and N=24."""
    rs = np.random.RandomState(2)
    counts = [3, 8, 0, 5]
    jx, px = _buf(rs, K, dtype, counts, 8)
    jdy, pdy = _buf(rs, 24, dtype, counts, 8)
    jc = jnp.asarray(counts, jnp.int32)
    pc = torch.tensor(counts, dtype=torch.int32)
    dw = pgg.tgmm(px, pdy, pc)
    assert dw.dtype == torch.float32 and dw.shape == (4, K, 24)
    _close(dw, jgg.tgmm(jx, jdy, jc, block_m=8), "float32")
    assert float(dw[2].abs().max()) == 0.0


@pytest.mark.parametrize("c_pad,k,n", [(40, 16, 24), (72, 70, 37)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tgmm_twin_ignores_dead_rows_and_matches_jax(dtype, c_pad, k, n):
    """The twin reads each expert's first ``counts[e]`` rows only: with
    NaN, inf and noise in the rows after them it gives the bits it gives
    with zeros there, and those match JAX's ``_tgmm_call`` (through
    ``tgmm``, interpret mode) at the fp32 tier. ``c_pad`` no multiple of
    64, counts 0, 3, ``c_pad`` and one ending inside a 64-row tile, K and
    N no multiples of 8 (70, 37) beside (16, 24)."""
    rs = np.random.RandomState(7)
    counts = [0, 3, c_pad, c_pad - 5]
    jx, px = _buf(rs, k, dtype, counts, c_pad)
    jdy, pdy = _buf(rs, n, dtype, counts, c_pad)
    pc = torch.tensor(counts, dtype=torch.int32)
    dead = (torch.arange(c_pad)[None, :] >= pc[:, None]).reshape(-1, 1)
    noise = torch.from_numpy(rs.randn(*px.shape).astype(np.float32))
    gx = torch.where(dead, noise.to(px.dtype), px)
    gx[dead[:, 0].nonzero()[::2, 0]] = float("nan")
    gdy = pdy.masked_fill(dead, float("inf"))
    dw = pgg.tgmm(gx, gdy, pc)
    assert torch.equal(dw, pgg.tgmm(px, pdy, pc))
    _close(dw, jgg.tgmm(jx, jdy, jnp.asarray(counts, jnp.int32), block_m=8),
           "float32")
    assert float(dw[0].abs().max()) == 0.0


def test_routes_by_shape_and_alignment():
    """A bf16 call takes the ``wgmma`` kernels exactly where TMA can map
    it (K and N multiples of 8, every base 16-byte aligned), else the WMMA
    kernels: decided from shapes and pointers alone, before any launch."""
    x = torch.zeros(64, 16, dtype=torch.bfloat16)
    w = torch.zeros(4, 16, 24, dtype=torch.bfloat16)
    assert pgg._tma_ok(16, 24, x, w)
    assert not pgg._tma_ok(70, 24, x, w)
    assert not pgg._tma_ok(16, 37, x, w)
    off = torch.zeros(64 * 16 + 1, dtype=torch.bfloat16)[1:].view(64, 16)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert not pgg._tma_ok(16, 24, off, w)
    assert pgg._tma_ok(16, 24, x[8:16], w)      # a view at +256 bytes


def _routing(rs, n, k, e_num, cap):
    """The gate's contract: per-expert arrival slots, keep = slot < cap."""
    e_idx = np.zeros((n, k), np.int32)
    for i in range(n):
        e_idx[i] = rs.choice(e_num, size=k, replace=False)
    slot = np.zeros((n, k), np.int32)
    seen = {}
    for j in range(k):
        for i in range(n):
            e = int(e_idx[i, j])
            slot[i, j] = seen.get(e, 0)
            seen[e] = seen.get(e, 0) + 1
    return e_idx, slot, slot < cap, rs.rand(n, k).astype(np.float32)


def test_sorted_dispatch_and_combine_match_jax():
    """Top-2 routing of 12 tokens over 3 experts at capacity 5 (tokens
    dropped), c_pad 8: buffer, counts and dest equal exactly, the combine
    and the gradients of tokens and weights at the fp32 tier."""
    rs = np.random.RandomState(3)
    n, m, e_num, cap, c_pad = 12, 4, 3, 5, 8
    e_idx, slot, keep, w = _routing(rs, n, 2, e_num, cap)
    assert not keep.all()
    tokens = rs.randn(n, m).astype(np.float32)
    jt = (jnp.asarray(e_idx), jnp.asarray(slot), jnp.asarray(keep))
    pt = tuple(torch.from_numpy(a) for a in (e_idx, slot, keep))
    jx, jcnt, jdest = jgg.sorted_dispatch(jnp.asarray(tokens), *jt, e_num,
                                          c_pad)
    ptok = torch.from_numpy(tokens).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    px, pcnt, pdest = pgg.sorted_dispatch(ptok, *pt, e_num, c_pad)
    assert np.array_equal(px.detach().numpy(), np.asarray(jx))
    assert np.array_equal(pcnt.numpy(), np.asarray(jcnt))
    assert np.array_equal(pdest.numpy(), np.asarray(jdest))
    assert pcnt.dtype == pdest.dtype == torch.int32

    def jfn(tok, wt):
        xb, _, dest = jgg.sorted_dispatch(tok, *jt, e_num, c_pad)
        return jgg.sorted_combine(xb * 2.0, dest, wt, jt[2], n)

    jy, vjp = jax.vjp(jfn, jnp.asarray(tokens), jnp.asarray(w))
    cot = rs.randn(n, m).astype(np.float32)
    jgt, jgw = vjp(jnp.asarray(cot))
    py = pgg.sorted_combine(px * 2.0, pdest, pw, pt[2], n)
    pgt, pgw = torch.autograd.grad(py, (ptok, pw), torch.from_numpy(cot))
    for got, want in ((py, jy), (pgt, jgt), (pgw, jgw)):
        _close(got, want, "float32", scaled=False)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_mlp_matches_jax(dtype, fused):
    """The SwiGLU expert MLP over the buffer, through gmm2 (``fused``) or
    two gmm calls on both sides (``moe_fused_wi``), forward and the
    gradients of the buffer and the three weight stacks."""
    rs = np.random.RandomState(4)
    ffn = 24
    jx, px = _buf(rs, K, dtype)
    jg, pg = _rand(rs, (4, K, ffn), dtype, 0.3)
    ju, pu = _rand(rs, (4, K, ffn), dtype, 0.3)
    jd, pd = _rand(rs, (4, ffn, K), dtype, 0.3)
    jcot, pcot = _buf(rs, K, dtype)
    jc, pc = _counts()
    ct = jnp.dtype(dtype)
    old = jax_flags.flag("moe_fused_wi"), pt_flags.flag("moe_fused_wi")
    jax_flags.set_flags({"moe_fused_wi": fused})
    pt_flags.set_flags({"moe_fused_wi": fused})
    try:
        jy, vjp = jax.vjp(lambda *a: jgg.expert_mlp(
            a[0], jc, *a[1:], block_m=8, block_n=128, ct=ct),
            jx, jg, ju, jd)
        jgrads = vjp(jcot)
        ins = [t.requires_grad_(True) for t in (px, pg, pu, pd)]
        py = pgg.expert_mlp(ins[0], pc, *ins[1:])
        pgrads = torch.autograd.grad(py, ins, pcot)
    finally:
        jax_flags.set_flags({"moe_fused_wi": old[0]})
        pt_flags.set_flags({"moe_fused_wi": old[1]})
    _close(py, jy, dtype)
    for got, want in zip(pgrads, jgrads):
        _close(got, want, dtype)


def test_plain_expert_mlp_equals_the_wrapped_one():
    """``plain=True`` (the serving reference) runs the same twins as the
    wrappers do on CPU tensors: equal bits."""
    rs = np.random.RandomState(5)
    _, px = _buf(rs, K, "float32")
    ws = [_rand(rs, s, "bfloat16", 0.3)[1]
          for s in ((4, K, 24), (4, K, 24), (4, 24, K))]
    _, pc = _counts()
    assert torch.equal(pgg.expert_mlp(px, pc, *ws, plain=True),
                       pgg.expert_mlp(px, pc, *ws))


def test_grouped_path_flag_and_eligibility():
    """``auto`` and ``on`` take the grouped path, ``off`` the index form
    (``fast_path_enabled``); the kernels take fp32 and bf16 and refuse
    fp16 (``eligible``), whose experts take the index form; any other
    flag value raises."""
    old = pt_flags.flag("moe_grouped_gemm")
    try:
        for mode in ("auto", "on"):
            pt_flags.set_flags({"moe_grouped_gemm": mode})
            assert pgg.fast_path_enabled()
            for dtype in (torch.float32, torch.bfloat16):
                assert pgg.eligible(4, 64, 16, 32, dtype)
            assert not pgg.eligible(4, 64, 16, 32, torch.float16)
        pt_flags.set_flags({"moe_grouped_gemm": "off"})
        assert not pgg.fast_path_enabled()
        pt_flags.set_flags({"moe_grouped_gemm": "sometimes"})
        with pytest.raises(ValueError, match="moe_grouped_gemm"):
            pgg.fast_path_enabled()
    finally:
        pt_flags.set_flags({"moe_grouped_gemm": old})
    assert [pgg.padded_capacity(c) for c in (1, 64, 65, 4096)] == \
        [64, 64, 128, 4096]
