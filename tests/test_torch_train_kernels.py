"""The twins of the training slice's kernels against the JAX Pallas
kernels, forward and backward.

Each port function runs on CPU tensors (its plain twin, through its
autograd Function) and each reference runs as the JAX tests run it on the
CPU (Pallas interpret mode), under ``jax.vjp``, on the same numpy inputs
and cotangents. Shapes are small, with GQA, small blocks and sequence
lengths that are no multiple of the block. Tolerances follow
``tests/op_harness.py``: fp32 rtol 1e-5 / atol 1e-6 and bf16 2e-2,
except where a test states a looser one with its reason. The CUDA
kernels are held against these twins on a card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu.ops.pallas import fused_block as jax_fb
from paddle_tpu.ops.pallas import rms_norm as jax_rms
from paddle_tpu_torch.incubate.nn import functional as pt_inc
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as pt_flash
from paddle_tpu_torch.ops.kernels import fused_block as pt_fb
from paddle_tpu_torch.ops.kernels import rms_norm as pt_rms
from paddle_tpu_torch.weights import to_torch

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor that requires
    grad."""
    ja = jnp.asarray(a, getattr(jnp, dtype))
    return ja, to_torch(np.asarray(ja)).requires_grad_(True)


def _port_vjp(fn, tensors, cot):
    out = fn(*tensors)
    grads = torch.autograd.grad(out, tensors, cot)
    return out, grads


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


def _close_scaled(port, ref, tol):
    """The tier's rtol, and its atol times the tensor's largest
    magnitude: an element that is a long sum (a weight gradient, a row
    through three products) is off by the rounding of its terms, whose
    size is the tensor's scale and not the element's."""
    ref = _np(ref)
    np.testing.assert_allclose(_np(port), ref, rtol=tol["rtol"],
                               atol=tol["atol"] * np.abs(ref).max())


# --------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,d,hq,hkv", [
    pytest.param(True, 40, 40, 64, 4, 2, id="True-40-40"),
    pytest.param(False, 24, 40, 64, 4, 2, id="False-24-40"),
    pytest.param(True, 40, 40, 128, 6, 2, id="True-40-40-d128-gqa3"),
    pytest.param(False, 24, 40, 128, 6, 2, id="False-24-40-d128-gqa3")])
def test_flash_backward_matches_jax(dtype, causal, sq, sk, d, hq, hkv):
    """dQ, dK and dV of GQA attention (4:2 at head dim 64, and the train
    shape's 3:1 at head dim 128) with 16-row blocks on the JAX side; dK/dV
    come back summed over each kv head's query heads. At head dim 128 the
    gradients are held with atol scaled by their largest magnitude: the
    causal first row's dQ is zero up to the cancellation of ``dp - delta``
    (~2e-6 in fp32 here, against values of order 1), which each side
    rounds differently."""
    rng = np.random.RandomState(10)
    q = _pair(rng.randn(2, sq, hq, d), dtype)
    k = _pair(rng.randn(2, sk, hkv, d), dtype)
    v = _pair(rng.randn(2, sk, hkv, d), dtype)
    do = _pair(rng.randn(2, sq, hq, d), dtype)

    def ref_fn(a, b, c):
        return jax_flash.flash_attention(a, b, c, is_causal=causal,
                                         block_q=16, block_k=16)

    ref_o, vjp = jax.vjp(ref_fn, q[0], k[0], v[0])
    ref_g = vjp(do[0])
    out, grads = _port_vjp(
        lambda a, b, c: pt_flash.FlashAttentionFunction.apply(a, b, c,
                                                              causal),
        [q[1], k[1], v[1]], do[1].detach())
    tol = FP32 if dtype == "float32" else BF16
    _close(out, ref_o, tol)
    for g, r, t in zip(grads, ref_g, (q, k, v)):
        assert g.dtype == t[1].dtype and g.shape == t[1].shape
        (_close if d == 64 else _close_scaled)(g, r, tol)


def test_flash_backward_twin_of_the_kernels_call():
    """``flash_attention_bwd`` on CPU tensors is the plain twin, fed the
    forward's O and lse, and counts no launch."""
    kernels.reset_launch_counts()
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 9, h, 64).astype(np.float32))
               for h in (2, 1, 1))
    o, lse = pt_flash.flash_attention_with_lse(q, k, v, True)
    do = torch.from_numpy(rng.randn(1, 9, 2, 64).astype(np.float32))
    got = pt_flash.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = pt_flash.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


# ----------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_rms_norm_backward_matches_jax(x_dtype):
    """dx in x's dtype and dw (fp32 weight) from a width that is no
    multiple of 128 and rows that are no multiple of the TPU row block.
    dw sums 21 rows in another order than the TPU kernel's: fp32 atol
    1e-5 on it."""
    rng = np.random.RandomState(12)
    x = _pair(rng.randn(3, 7, 200) * 3.0, x_dtype)
    w = _pair(1.0 + 0.1 * rng.randn(200), "float32")
    dy = _pair(rng.randn(3, 7, 200), x_dtype)
    ref_y, vjp = jax.vjp(lambda a, b: jax_rms.rms_norm(a, b, 1e-6), x[0],
                         w[0])
    ref_dx, ref_dw = vjp(dy[0])
    y, (dx, dw) = _port_vjp(
        lambda a, b: pt_rms.RMSNormFunction.apply(a, b, 1e-6),
        [x[1], w[1]], dy[1].detach())
    assert dx.dtype == x[1].dtype and dw.dtype == torch.float32
    if x_dtype == "float32":
        _close(y, ref_y, FP32)
        _close(dx, ref_dx, FP32)
        _close(dw, ref_dw, dict(rtol=1e-5, atol=1e-5))
    else:
        for a, b in ((y, ref_y), (dx, ref_dx), (dw, ref_dw)):
            _close(a, b, BF16)


# ------------------------------------------------------------- fused block
def _block_inputs(dtype, seed=13, b=2, s=20, nh=4, nkv=2, d=16, ffn=96):
    rng = np.random.RandomState(seed)
    hidden = nh * d
    shapes = dict(q=(b, s, nh, d), k=(b, s, nkv, d), v=(b, s, nkv, d),
                  resid=(b, s, hidden), wo=(nh * d, hidden),
                  wg=(hidden, ffn), wu=(hidden, ffn), wd=(ffn, hidden))
    scale = dict(q=1.0, k=1.0, v=1.0, resid=1.0, wo=0.2, wg=0.2, wu=0.2,
                 wd=0.2)
    arrays = {n: _pair(rng.randn(*sh) * scale[n], dtype)
              for n, sh in shapes.items()}
    arrays["wn"] = _pair(1.0 + 0.1 * rng.randn(hidden), "float32")
    dy = _pair(rng.randn(b, s, hidden), dtype)
    order = ("q", "k", "v", "resid", "wn", "wo", "wg", "wu", "wd")
    return [arrays[n] for n in order], dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_matches_jax_fused_kernel(dtype):
    """Forward against the JAX fused kernel (8-row q blocks, 8-key
    blocks, 32-wide ffn blocks, s=20: a ragged last block), and the
    gradients of all nine inputs against its vjp (the composed
    recompute), at the tiers with atol scaled by each tensor's largest
    magnitude (``_close_scaled``). Measured: relative L2 errors ~4e-7 in
    fp32 and ~0.5-0.7% in bf16 (one bf16 ulp of an intermediate)."""
    args, dy = _block_inputs(dtype)
    ref_out, vjp = jax.vjp(
        lambda *a: jax_fb.fused_block(*a, eps=1e-5, blocks=(8, 8, 32)),
        *[a[0] for a in args])
    ref_g = vjp(dy[0])
    out, grads = _port_vjp(lambda *a: pt_inc.fused_block(*a, eps=1e-5),
                           [a[1] for a in args], dy[1].detach())
    assert out.dtype == args[3][1].dtype
    tol = FP32 if dtype == "float32" else BF16
    _close_scaled(out, ref_out, tol)
    for g, r, a in zip(grads, ref_g, args):
        assert g.dtype == a[1].dtype and g.shape == a[1].shape
        _close_scaled(g, r, tol)


def test_fused_block_twin_is_the_composed_block_in_fp32():
    """In fp32 the kernel's rounding points are no-ops, so its twin is
    the composed block up to summation order."""
    args, _ = _block_inputs("float32", seed=14)
    t = [a[1].detach() for a in args]
    np.testing.assert_allclose(
        _np(pt_fb.fused_block_plain(*t, eps=1e-5)),
        _np(pt_fb.fused_block_composed(*t, eps=1e-5)), rtol=1e-5, atol=1e-5)


def test_fused_block_ineligible_reasons():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert pt_fb.ineligible_reason((1, 8, 4, 16), (1, 8, 3, 16), 64, 96,
                                   torch.float32, cpu).startswith("GQA")
    assert "o_proj" in pt_fb.ineligible_reason(
        (1, 8, 4, 16), (1, 8, 2, 16), 48, 96, torch.float32, cpu)
    assert pt_fb.ineligible_reason((1, 8, 4, 16), (1, 8, 2, 16), 64, 96,
                                   torch.float32, cpu) is None
    # the CUDA kernel's own limits are checked before any build
    assert "head_dim" in pt_fb.ineligible_reason(
        (1, 8, 4, 16), (1, 8, 2, 16), 64, 96, torch.float32, cuda)
    assert "float32 or bfloat16" in pt_fb.ineligible_reason(
        (1, 8, 2, 64), (1, 8, 2, 64), 128, 96, torch.float16, cuda)
