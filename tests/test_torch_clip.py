"""The port's gradient clipping against the JAX package's.

The five clip APIs take the same mixed bf16/fp32 gradients (numpy, from a
seed) on both sides, at a limit that clips and at one that does not;
norms are taken in fp32 on both. Tolerances: fp32 rtol 1e-5 / atol 1e-6,
bf16 2e-2 (``tests/op_harness.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu_torch import nn as pt_nn
from paddle_tpu_torch.weights import to_torch

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
SHAPES = (((6, 5), "bfloat16"), ((5,), "float32"), ((3, 4), "bfloat16"),
          ((7,), "float32"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    if isinstance(x, JTensor):
        x = x._data
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _pairs(scale=1.0, seed=0, none_at=None):
    """JAX and port parameters with equal mixed-dtype gradients
    (``none_at``: the index of a parameter without one)."""
    rng = np.random.RandomState(seed)
    jps, pps = [], []
    for i, (shape, dt) in enumerate(SHAPES):
        w = np.asarray(jnp.asarray(rng.randn(*shape), jnp.float32).astype(dt))
        g = np.asarray(jnp.asarray(scale * rng.randn(*shape),
                                   jnp.float32).astype(dt))
        jp = paddle.to_tensor(w, stop_gradient=False)
        pp = torch.nn.Parameter(to_torch(w))
        if i != none_at:
            jp.grad = JTensor(jnp.asarray(g))
            pp.grad = to_torch(g)
        jps.append(jp)
        pps.append(pp)
    return jps, pps


def _close(got, want):
    for a, b in zip(got, want):
        if a is None or b is None:
            assert a is None and b is None
            continue
        assert a.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[str(b._data.dtype)]
        tol = BF16 if a.dtype == torch.bfloat16 else FP32
        np.testing.assert_allclose(_np(a), _np(b), **tol)


CLASSES = {
    "value": lambda mod, lim: mod.ClipGradByValue(lim),
    "value_asym": lambda mod, lim: mod.ClipGradByValue(lim, min=-lim / 2),
    "norm": lambda mod, lim: mod.ClipGradByNorm(lim),
    "global_norm": lambda mod, lim: mod.ClipGradByGlobalNorm(lim),
}


@pytest.mark.parametrize("none_at", [None, 1], ids=["all", "one_none"])
@pytest.mark.parametrize("limit", [0.5, 100.0], ids=["clips", "passes"])
@pytest.mark.parametrize("kind", list(CLASSES))
def test_clip_class_matches_jax(kind, limit, none_at):
    """The ``(parameter, gradient)`` list in, the clipped list out: each
    gradient keeps its dtype and matches JAX's; a missing gradient stays
    missing; the parameters' own ``.grad`` are left as they were."""
    jps, pps = _pairs(seed=1, none_at=none_at)
    before = [None if p.grad is None else p.grad.clone() for p in pps]
    jout = CLASSES[kind](jax_nn, limit)([(p, p.grad) for p in jps])
    pout = CLASSES[kind](pt_nn, limit)([(p, p.grad) for p in pps])
    assert [p for p, _ in pout] == pps
    _close([g for _, g in pout], [g for _, g in jout])
    for p, b in zip(pps, before):
        assert (p.grad is None and b is None) or torch.equal(p.grad, b)
    if limit == 100.0 and kind != "value_asym":
        for (_, g), p in zip(pout, pps):
            assert g is None or torch.equal(g, p.grad)


def test_global_norm_factor_uses_the_fp32_norm():
    """The clipped gradients' global norm is the limit (fp32 tier, each
    bf16 gradient rounded once from the fp32 product)."""
    _, pps = _pairs(scale=3.0, seed=2)
    out = pt_nn.ClipGradByGlobalNorm(1.0)([(p, p.grad) for p in pps])
    norms = [torch.linalg.vector_norm(g.float()) for _, g in out]
    total = float(torch.linalg.vector_norm(torch.stack(norms)))
    assert abs(total - 1.0) < 1e-2
    want = pt_nn.ClipGradByGlobalNorm(1.0).global_norm(
        [p.grad for p in pps])
    exact = np.sqrt(sum((_np(p.grad) ** 2).sum() for p in pps))
    np.testing.assert_allclose(float(want), exact, rtol=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, 3.0, float("inf")],
                         ids=["l2", "l1", "l3", "inf"])
@pytest.mark.parametrize("max_norm", [0.5, 1e4], ids=["clips", "passes"])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    """In place on ``p.grad``; the returned total norm (fp32 on the port)
    against JAX's."""
    jps, pps = _pairs(seed=3)
    jt = jax_nn.clip_grad_norm_(jps, max_norm, norm_type=norm_type)
    pt = pt_nn.clip_grad_norm_(pps, max_norm, norm_type=norm_type)
    assert pt.dtype == torch.float32 and pt.shape == ()
    np.testing.assert_allclose(float(pt), float(jt.numpy()), rtol=1e-5)
    _close([p.grad for p in pps], [p.grad for p in jps])


def test_clip_grad_norm_of_one_tensor_and_of_none():
    jps, pps = _pairs(seed=4)
    jt = jax_nn.clip_grad_norm_(jps[1], 0.1)
    pt = pt_nn.clip_grad_norm_(pps[1], 0.1)
    np.testing.assert_allclose(float(pt), float(jt.numpy()), rtol=1e-5)
    _close([pps[1].grad], [jps[1].grad])
    empty = torch.nn.Parameter(torch.zeros(2))
    assert float(pt_nn.clip_grad_norm_([empty], 1.0)) == 0.0


@pytest.mark.parametrize("clip_value", [0.3, 10.0])
def test_clip_grad_value_matches_jax(clip_value):
    jps, pps = _pairs(seed=5, none_at=2)
    jax_nn.clip_grad_value_(jps, clip_value)
    pt_nn.clip_grad_value_(pps, clip_value)
    _close([p.grad for p in pps], [p.grad for p in jps])
    # a gradient clips to the limit rounded to its dtype
    assert all(float(p.grad.abs().max()) <= float(torch.tensor(
        clip_value, dtype=p.grad.dtype)) for p in pps if p.grad is not None)


@pytest.mark.parametrize("kind", ["norm", "global_norm"])
def test_optimizer_grad_clip_matches_jax(kind):
    """``grad_clip`` on an optimizer clips before the update: SGD steps on
    clipped gradients against JAX's."""
    from paddle_tpu import optimizer as jax_optimizer
    from paddle_tpu_torch import optimizer as pt_optimizer
    jps, pps = _pairs(scale=5.0, seed=6)
    jopt = jax_optimizer.SGD(learning_rate=0.1, parameters=jps,
                             grad_clip=CLASSES[kind](jax_nn, 1.0))
    popt = pt_optimizer.SGD(learning_rate=0.1, parameters=pps,
                            grad_clip=CLASSES[kind](pt_nn, 1.0))
    jopt.step()
    popt.step()
    _close(pps, jps)
