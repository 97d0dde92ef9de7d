"""The port's fused-op surface against the JAX package's, on the same
numpy inputs: neox RoPE rotates every tensor it is given, ``v``
included. Tolerances follow ``tests/op_harness.py``: fp32 rtol 1e-5 /
atol 1e-6, bf16 2e-2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn import functional as jax_fused
from paddle_tpu_torch.incubate.nn import functional as pt_fused
from paddle_tpu_torch.weights import to_torch

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_k", [True, False])
def test_rope_matches_jax_on_q_k_and_v(dtype, with_k):
    """``[1, 6, 2, 8]`` tensors from seed 0 (and a GQA-shaped k/v): each
    output matches the reference, whose RoPE rotates ``v`` too."""
    rng = np.random.RandomState(0)
    arrays = [rng.randn(*shape) for shape in
              ([1, 6, 2, 8], [1, 6, 1, 8], [1, 6, 1, 8])]
    jt = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    pt = [to_torch(np.asarray(a)) for a in jt]
    if not with_k:
        jt[1] = pt[1] = None
    ref = jax_fused.fused_rotary_position_embedding(
        jt[0], jt[1], jt[2], use_neox_rotary_style=True,
        rotary_emb_base=10000.0)
    out = pt_fused.fused_rotary_position_embedding(
        pt[0], pt[1], pt[2], use_neox_rotary_style=True,
        rotary_emb_base=10000.0)
    tol = FP32 if dtype == "float32" else BF16
    for r, o in zip(ref, out):
        assert (r is None) == (o is None)
        if o is None:
            continue
        assert o.dtype == pt[0].dtype
        np.testing.assert_allclose(_np(o), _np(r.numpy()), **tol)
    # v is rotated, not passed through
    assert not torch.equal(out[2], pt[2])
