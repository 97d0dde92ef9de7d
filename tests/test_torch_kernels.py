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
from paddle_tpu.ops.pallas import ragged_paged_attention as jax_ragged
from paddle_tpu.ops.pallas import rms_norm as jax_rms
from paddle_tpu_torch.inference.attention import paged_attention_ragged
from paddle_tpu_torch.nn.functional import common as pt_common
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as pt_flash
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
