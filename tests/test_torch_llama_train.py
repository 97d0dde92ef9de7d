"""The port's Llama training step against the JAX package's.

The JAX model is built from a seed and its weights are carried into the
port with ``load_jax_state``; the batch is made with numpy. Both sides
run the step of ``bench.py:_llama_run`` (``loss, _ = model(ids,
labels=ids); loss.backward(); opt.step(); opt.clear_grad()`` under their
``jit.to_static``, AdamW with weight decay 0.1) with the
``pallas_fused_block`` flag set on both sides and restored after. On the
CPU the port's kernel wrappers run their plain twins and the JAX Pallas
kernels run in interpret mode. Tolerances follow ``tests/op_harness.py``
(fp32 rtol 1e-5 / atol 1e-6, bf16 2e-2) unless a test states its own.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.models import llama as jax_llama
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch import jit as pt_jit
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.weights import load_jax_state, to_torch

BF16 = dict(rtol=2e-2, atol=2e-2)
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x.astype("float32").numpy(), np.float64)


@contextlib.contextmanager
def fused_block(mode):
    """``pallas_fused_block`` set to ``mode`` on both sides."""
    old = jax_flags.flag("pallas_fused_block"), \
        pt_flags.flag("pallas_fused_block")
    jax_flags.set_flags({"pallas_fused_block": mode})
    pt_flags.set_flags({"pallas_fused_block": mode})
    try:
        yield
    finally:
        jax_flags.set_flags({"pallas_fused_block": old[0]})
        pt_flags.set_flags({"pallas_fused_block": old[1]})


def _models(dtype, seed=21):
    paddle.seed(seed)
    jcfg = jax_llama.llama_tiny_config(dtype=dtype, **TINY)
    jm = jax_llama.LlamaForCausalLM(jcfg)
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    pcfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name in names})
    pm = LlamaForCausalLM(pcfg, device="cpu")
    load_jax_state(pm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, pm


def _train(jm, pm, ids, steps, lr=1e-3):
    """``steps`` AdamW steps on each side; per-step losses of both."""
    jopt = jax_optimizer.AdamW(learning_rate=lr, weight_decay=0.1,
                               parameters=jm.parameters())
    popt = pt_optimizer.AdamW(learning_rate=lr, weight_decay=0.1,
                              parameters=pm.parameters())

    @paddle.jit.to_static
    def jstep(x):
        loss, _ = jm(x, labels=x)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    @pt_jit.to_static
    def pstep(x):
        loss, _ = pm(x, labels=x)
        loss.backward()
        popt.step()
        popt.clear_grad()
        return loss.detach()

    jids, pids = paddle.to_tensor(ids), torch.from_numpy(ids)
    jl = [float(jstep(jids).numpy()) for _ in range(steps)]
    pl = [float(pstep(pids)) for _ in range(steps)]
    return np.asarray(jl), np.asarray(pl)


def _params_close(jm, pm, share=1.0, loose=None, **tol):
    """Every parameter within ``tol``, or, with ``loose``, a ``share`` of
    all elements within ``tol`` and every element within ``loose``."""
    jstate = jm.state_dict()
    within = total = 0
    for name, p in pm.named_parameters():
        assert p.grad is None, name            # clear_grad ran
        a, b = _np(p), _np(jstate[name])
        if loose is None:
            np.testing.assert_allclose(a, b, **tol, err_msg=name)
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=loose, err_msg=name)
        within += int(np.isclose(a, b, **tol).sum())
        total += a.size
    assert within >= share * total, (within, total)


@pytest.mark.parametrize("mode", ["on", "off"])
def test_three_adamw_steps_match_jax_fp32(mode):
    """Tiny fp32 Llama (2 layers, GQA 4:2, s=24: no multiple of the
    kernels' blocks), 3 steps at lr 1e-3. Losses at rtol 1e-5 (measured
    ~1e-7). Parameters: 99.9% of elements at rtol 1e-5 / atol 1e-6 and
    every element within 1e-4, a tenth of one step's size: Adam divides
    m by sqrt(v), so an element whose gradient is near zero moves by a
    share of lr that fp32 rounding noise decides (measured worst 3.4e-5).
    ``on`` runs the fused block (its twin here, the interpreted Pallas
    kernel in JAX), ``off`` the composed path."""
    jm, pm = _models("float32")
    ids = np.random.RandomState(0).randint(0, 128, size=(2, 24)) \
        .astype("int32")
    kernels.reset_launch_counts()
    with fused_block(mode):
        jl, pl = _train(jm, pm, ids, 3)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pl[2] < pl[0]
    _params_close(jm, pm, share=0.999, loose=1e-4, rtol=1e-5, atol=1e-6)
    # CPU tensors: every wrapper took its twin
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


def test_bf16_step_matches_jax():
    """One bf16 step with the fused block: loss and updated weights at
    the bf16 tier (bf16 moments, the reference's rounding points)."""
    jm, pm = _models("bfloat16", seed=22)
    ids = np.random.RandomState(1).randint(0, 128, size=(2, 16)) \
        .astype("int32")
    with fused_block("on"):
        jl, pl = _train(jm, pm, ids, 1)
    np.testing.assert_allclose(pl, jl, **BF16)
    _params_close(jm, pm, **BF16)


def test_fused_layer_forward_is_differentiable_through_the_twins():
    """``LlamaDecoderLayer`` with the flag on runs the fused block and
    gives the same gradients as the composed path up to fp32 summation
    order."""
    _, pm = _models("float32", seed=23)
    layer = pm.llama.layers[0]
    h0 = torch.from_numpy(np.random.RandomState(2).randn(2, 11, 64)
                          .astype(np.float32))
    grads = {}
    for mode in ("on", "off"):
        h = h0.clone().requires_grad_(True)
        with fused_block(mode):
            out = layer(h)
        params = [h] + list(layer.parameters())
        grads[mode] = torch.autograd.grad(out.square().sum(), params)
    for a, b in zip(grads["on"], grads["off"]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


def test_logits_forward_is_differentiable_like_jax():
    """``model(ids)`` without labels returns differentiable logits, as
    the reference's does: a custom loss on them backpropagates, and every
    parameter's gradient matches JAX's (fp32, composed path, rtol 1e-5 /
    atol 1e-6)."""
    jm, pm = _models("float32", seed=24)
    ids = np.random.RandomState(5).randint(0, 128, size=(2, 9)) \
        .astype("int32")
    with fused_block("off"):
        jl = jm(paddle.to_tensor(ids))
        paddle.mean(jl * jl).backward()
        pl = pm(torch.from_numpy(ids))
        assert pl.requires_grad
        (pl * pl).mean().backward()
    jgrads = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jgrads[name].grad),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("masked", ["some", "all"])
def test_loss_ignore_index_matches_jax(masked):
    """``ignore_index=-100`` labels drop out of the mean; with every
    label ignored the loss is 0 over a count floored at 1. Loss and its
    gradient against the JAX ``_shifted_lm_loss``."""
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 7, 11).astype(np.float32)
    labels = rng.randint(0, 11, size=(2, 7)).astype(np.int32)
    if masked == "all":
        labels[:] = -100
    else:
        labels[0, 3:] = -100
        labels[1, 1] = -100
    jlog = paddle.to_tensor(logits, stop_gradient=False)
    jloss, jshift = jax_llama._shifted_lm_loss(jlog, paddle.to_tensor(labels))
    jloss.backward()
    plog = torch.from_numpy(logits).requires_grad_(True)
    ploss, pshift = pt_llama._shifted_lm_loss(plog, torch.from_numpy(labels))
    ploss.backward()
    assert ploss.dtype == torch.float32 and pshift.shape == (2, 6, 11)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss.numpy()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(plog.grad), _np(jlog.grad), rtol=1e-5,
                               atol=1e-6)
    if masked == "all":
        assert float(ploss) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_moments_in_the_parameter_dtype(dtype):
    """Two AdamW steps on one weight and an fp32 norm-like weight with
    given gradients: moments keep each parameter's dtype and the updated
    weights match JAX's AdamW (fp32 at rtol 1e-6, bf16 at the tier)."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(5, 3) * 0.1
    n0 = 1.0 + 0.1 * rng.randn(3)
    gs = [(rng.randn(5, 3), rng.randn(3)) for _ in range(2)]
    w_np = np.asarray(paddle.to_tensor(w0.astype(np.float32))
                      .astype(dtype).numpy())
    jw = paddle.to_tensor(w_np, stop_gradient=False)
    jn = paddle.to_tensor(n0.astype(np.float32), stop_gradient=False)
    pw = torch.nn.Parameter(to_torch(w_np))
    pn = torch.nn.Parameter(torch.from_numpy(n0.astype(np.float32)))
    jopt = jax_optimizer.AdamW(learning_rate=1e-2, weight_decay=0.1,
                               parameters=[jw, jn])
    popt = pt_optimizer.AdamW(learning_rate=1e-2, weight_decay=0.1,
                              parameters=[pw, pn])
    for gw, gn in gs:
        (jw * paddle.to_tensor(gw.astype(np.float32)).astype(dtype)).sum() \
            .backward()
        (jn * paddle.to_tensor(gn.astype(np.float32))).sum().backward()
        jopt.step()
        jopt.clear_grad()
        pw.grad = to_torch(np.asarray(paddle.to_tensor(
            gw.astype(np.float32)).astype(dtype).numpy()))
        pn.grad = torch.from_numpy(gn.astype(np.float32))
        popt.step()
        popt.clear_grad()
    for p in (pw, pn):
        for name in ("moment1", "moment2"):
            assert popt._acc(name, p).dtype == p.dtype
    assert pw.dtype == getattr(torch, dtype) and pn.dtype == torch.float32
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(pw), _np(jw), **tol)
    np.testing.assert_allclose(_np(pn), _np(jn), rtol=1e-6, atol=1e-7)
    assert int(popt._step_count) == 2 and pw.grad is None
