"""The port's paged decode attention (``paddle_tpu_torch/ops/kernels/
paged_attention.py`` and ``inference/attention.py:paged_attention_decode``)
against the JAX package's.

Caches, queries and block tables are made with numpy from seeds. The JAX
kernel (``paddle_tpu/ops/pallas/paged_attention.py``) runs in interpret
mode on the CPU, as ``tests/test_paged_attention_pallas.py`` runs it; the
port runs the kernel's plain twin. Tolerances follow ``tests/op_harness.py``:
fp32 rtol 1e-5 / atol 1e-6 (a softmax over up to 128 keys summed in
another order: atol 2e-6 where stated), bf16 2e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu.inference.attention import \
    paged_attention_decode as jax_decode
from paddle_tpu.ops.pallas import paged_attention as jpp
from paddle_tpu_torch.inference.attention import paged_attention_decode
from paddle_tpu_torch.ops.kernels import paged_attention as ppa

FP32 = dict(rtol=1e-5, atol=2e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)

CASES = [
    # b, hq, kv, d, block_size, max_blocks, lens
    (2, 8, 8, 128, 16, 4, [30, 64]),          # MHA, ragged
    (2, 8, 2, 128, 16, 4, [17, 50]),          # GQA 4:1
    (1, 4, 4, 128, 8, 3, [1]),                # one fresh token
    (3, 16, 4, 64, 32, 2, [33, 64, 5]),       # GQA, head_dim 64
]


def _inputs(b, hq, kv, d, bs, nb, dtype, seed=0):
    rs = np.random.RandomState(seed)
    num_blocks = b * nb + 1
    k = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    v = rs.randn(num_blocks * bs, kv, d).astype(np.float32)
    q = rs.randn(b, hq, d).astype(np.float32)
    # disjoint tables, block 0 left over as a pad target
    tables = np.arange(1, 1 + b * nb).reshape(b, nb).astype(np.int32)
    return q, k, v, tables


def _pair(arrs, lens, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    q, k, v, tables = arrs
    jax_args = (jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                tables, np.asarray(lens, np.int32))
    pt_args = (torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
               torch.from_numpy(v).to(td), torch.from_numpy(tables),
               torch.tensor(lens, dtype=torch.int32))
    return jax_args, pt_args


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


@pytest.mark.parametrize("b,hq,kv,d,bs,nb,lens", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_kernel(b, hq, kv, d, bs, nb, lens, dtype):
    jargs, pargs = _pair(_inputs(b, hq, kv, d, bs, nb, dtype), lens, dtype)
    want = jpp.paged_decode_attention(*jargs, bs)
    got = ppa.paged_decode_attention(*pargs, bs)
    assert got.dtype == pargs[0].dtype and tuple(got.shape) == (b, hq, d)
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_f64(got), _f64(want), **tol)


def test_padding_blocks_and_empty_rows():
    """Table entries past a sequence's length may name any block (the
    engine leaves stale ones); a sequence of length 0 gives exactly 0, as
    the TPU kernel's does."""
    q, k, v, _ = _inputs(2, 4, 2, 128, 8, 4, "float32", seed=1)
    t1 = np.asarray([[1, 2, 0, 0], [3, 0, 0, 0]], np.int32)
    t2 = np.asarray([[1, 2, 5, 3], [3, 7, 8, 4]], np.int32)
    lens = [10, 0]
    outs = []
    for t in (t1, t2):
        jargs, pargs = _pair((q, k, v, t), lens, "float32")
        got = ppa.paged_decode_attention(*pargs, 8)
        np.testing.assert_allclose(
            _f64(got), _f64(jpp.paged_decode_attention(*jargs, 8)), **FP32)
        outs.append(got)
    assert torch.equal(outs[0], outs[1])
    assert float(outs[0][1].abs().max()) == 0.0


def test_public_op_matches_jax_public_op():
    """``paged_attention_decode`` (the engine's entry) against the JAX
    op through its kernel, with numpy tables and lengths."""
    q, k, v, tables = _inputs(2, 8, 2, 128, 16, 4, "float32", seed=2)
    lens = np.asarray([20, 55], np.int32)
    old = jax_flags.flag("use_pallas_kernels")
    jax_flags.set_flags({"use_pallas_kernels": True})
    try:
        want = jax_decode(paddle.to_tensor(q), jnp.asarray(k),
                          jnp.asarray(v), tables, lens, 16)
    finally:
        jax_flags.set_flags({"use_pallas_kernels": old})
    got = paged_attention_decode(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), tables, lens, 16)
    np.testing.assert_allclose(_f64(got), np.asarray(want.numpy(),
                                                     np.float64), **FP32)


def test_twin_is_differentiable_on_the_cpu():
    """The composed path's vjp, as the reference's grad route: the query's
    gradient matches JAX's through the composed op."""
    q, k, v, tables = _inputs(1, 4, 2, 128, 8, 2, "float32", seed=3)
    lens = np.asarray([12], np.int32)
    jq = paddle.to_tensor(q, stop_gradient=False)
    jax_decode(jq, jnp.asarray(k), jnp.asarray(v), tables, lens,
               8).sum().backward()
    pq = torch.from_numpy(q).requires_grad_(True)
    paged_attention_decode(pq, torch.from_numpy(k), torch.from_numpy(v),
                           tables, lens, 8).sum().backward()
    np.testing.assert_allclose(pq.grad.double().numpy(),
                               np.asarray(jq.grad.numpy(), np.float64),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,kv,d,ok", [
    ((2, 8, 128), 2, 128, True), ((2, 4, 64), 4, 64, True),
    ((2, 8, 96), 2, 96, True), ((2, 6, 128), 4, 128, False),
    ((2, 64, 128), 1, 128, False), ((2, 8, 256), 2, 256, True),
    ((2, 8, 72), 2, 72, False)])
def test_eligible(shape, kv, d, ok):
    """A head_dim that is a multiple of 16 up to 256 (72, a multiple of 8
    only, is refused) and whole GQA groups of at most 32 query heads."""
    assert ppa.eligible(shape, kv, d) is ok
