"""Hybrid attention+SSM training in the port against the JAX package: the
scan's backward, the hybrid's training step and ``recompute``.

Inputs and token batches are made with numpy from seeds; weights are made
by the JAX models from a seed and carried across with ``load_jax_state``.
The JAX scan runs its Pallas kernel in interpret mode
(``pallas_selective_scan=on``), whose backward is ``jax.vjp`` of its
chunked reference; on the CPU the port runs the kernels' plain twins:
``scan_chunked_bwd_plain`` is the backward kernel's, and autograd
differentiates the forward's chunked twin. Tolerances follow
``tests/op_harness.py``: fp32 rtol 1e-5 / atol 1e-6, with atol scaled by
each tensor's largest magnitude (every gradient is a sum over a chunk and
the carried state, taken in another order), bf16 2e-2. Recompute parity
uses the reference's own tolerance (``tests/test_ssm.py:218-239``: loss
rtol 1e-5, gradients rtol 1e-4 / atol 1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.models import HybridSSMForCausalLM as JaxHybrid
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.models import ssm_tiny_config as jax_ssm_tiny
from paddle_tpu.ops.pallas import selective_scan as jss
from paddle_tpu_torch import jit as pt_jit
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch.autograd import recompute
from paddle_tpu_torch.models import (HybridSSMForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, SSMConfig)
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import selective_scan as pss
from paddle_tpu_torch.weights import load_jax_state

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
RECOMPUTE = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _jax_chunked_scan():
    """The JAX scan through its Pallas kernel (interpreted on the CPU)."""
    old = jax_flags.flag("pallas_selective_scan")
    jax_flags.set_flags({"pallas_selective_scan": "on"})
    yield
    jax_flags.set_flags({"pallas_selective_scan": old})
    jss.reset_scan_path_counts()


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    data = getattr(a, "_data", a)
    return np.asarray(jnp.asarray(data, jnp.float32), np.float64)


def _close(got, want, tol, err_msg=""):
    """atol scaled by ``want``'s largest magnitude (at least 1)."""
    w = _f64(want)
    np.testing.assert_allclose(_f64(got), w, rtol=tol["rtol"],
                               atol=tol["atol"] * max(np.abs(w).max(), 1.0),
                               err_msg=err_msg)


# ------------------------------------------------ the scan's backward
def _padded_operands(b, lp, h, dh, ds, tail, seed):
    """``scan_chunked``'s operands as ``selective_scan`` pads them: the
    last ``tail`` positions zero dt*x, B and C and zero log-decay."""
    rs = np.random.RandomState(seed)
    dtx = rs.randn(b, lp, h, dh).astype(np.float32)
    la = -(np.abs(rs.randn(b, h, lp)) * 0.1 + 0.01).astype(np.float32)
    B = rs.randn(b, lp, ds).astype(np.float32)
    C = rs.randn(b, lp, ds).astype(np.float32)
    if tail:
        dtx[:, -tail:], B[:, -tail:], C[:, -tail:] = 0, 0, 0
        la[..., -tail:] = 0
    dy = rs.randn(b, lp, h, dh).astype(np.float32)
    if tail:
        dy[:, -tail:] = 0
    dsf = rs.randn(b, h, ds, dh).astype(np.float32)
    return dtx, la, B, C, dy, dsf


@pytest.mark.parametrize("h,dtype,with_ds,tail,chunk", [
    (1, "float32", True, 0, 16),
    (4, "float32", False, 0, 32),
    (4, "float32", True, 20, 16),
    (4, "bfloat16", True, 20, 16),
    (1, "bfloat16", False, 0, 32)])
def test_scan_backward_matches_jax_vjp(h, dtype, with_ds, tail, chunk):
    """``scan_chunked_bwd_plain`` (the kernel's twin, from the forward's
    saved states) and autograd through the chunked twin against
    ``jax.vjp`` of the reference's chunked scan (``selective_scan.py:202``),
    with and without a cotangent of the final state, over a zero-padded
    tail: (d_dtx, d_la, dB, dC)."""
    b, lp, dh, ds = 2, 64, 16, 16
    dtx, la, B, C, dy, dsf = _padded_operands(b, lp, h, dh, ds, tail,
                                              seed=h + chunk + tail)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    cfg = (b, lp, h, dh, ds, lp // chunk, chunk)
    jargs = (jnp.asarray(dtx, jd), jnp.asarray(la), jnp.asarray(B, jd),
             jnp.asarray(C, jd))
    _, vjp = jax.vjp(lambda *a: jss._scan_reference(*a, cfg), *jargs)
    jdsf = jnp.asarray(dsf) if with_ds else jnp.zeros((b, h, ds, dh))
    want = vjp((jnp.asarray(dy, jd), jdsf))

    pargs = (torch.from_numpy(dtx).to(td), torch.from_numpy(la),
             torch.from_numpy(B).to(td), torch.from_numpy(C).to(td))
    pdy = torch.from_numpy(dy).to(td)
    pdsf = torch.from_numpy(dsf) if with_ds else None
    _, _, states = pss._scan_reference(*pargs, chunk, with_states=True)
    plain = pss.scan_chunked_bwd_plain(*pargs, states, pdy, pdsf, chunk)
    leaves = [a.clone().requires_grad_(True) for a in pargs]
    y, s = pss._scan_reference(*leaves, chunk)
    loss = (y.float() * pdy.float()).sum()
    if with_ds:
        loss = loss + (s * pdsf).sum()
    loss.backward()
    tol = FP32 if dtype == "float32" else BF16
    for name, p, a, w in zip(("d_dtx", "d_la", "dB", "dC"), plain, leaves,
                             want):
        assert p.dtype == a.dtype, name
        _close(p, w, tol, f"plain {name}")
        _close(a.grad, w, tol, f"twin autograd {name}")
    assert pss.launches_bwd == 0


@pytest.mark.parametrize("l,chunk,dtype", [
    (64, 16, "float32"), (50, 16, "float32"), (100, 32, "float32"),
    (50, 16, "bfloat16")])
def test_selective_scan_gradients_match_jax(l, chunk, dtype):
    """``selective_scan``'s gradients to x, dt, A, B and C against
    ``jax.grad`` through the reference's ``_scan_core`` (its Pallas forward
    interpreted, its backward the chunked form's vjp), with cotangents of
    y and of the final state; 50 and 100 are no multiple of the chunk."""
    rs = np.random.RandomState(l + chunk)
    b, h, dh, ds = 2, 4, 16, 16
    x = rs.randn(b, l, h, dh).astype(np.float32)
    dt = (np.abs(rs.randn(b, l, h)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rs.randn(h)) - 0.1).astype(np.float32)
    B = rs.randn(b, l, ds).astype(np.float32)
    C = rs.randn(b, l, ds).astype(np.float32)
    wy = rs.randn(b, l, h, dh).astype(np.float32)
    ws = rs.randn(b, h, ds, dh).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)

    def jloss(x_, dt_, A_, B_, C_):
        y, s = jss.selective_scan(x_, dt_, A_, B_, C_, chunk=chunk)
        return (y.astype(jnp.float32) * wy).sum() + (s * ws).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
        jnp.asarray(B, jd), jnp.asarray(C, jd))
    leaves = [torch.from_numpy(x).to(td), torch.from_numpy(dt),
              torch.from_numpy(A), torch.from_numpy(B).to(td),
              torch.from_numpy(C).to(td)]
    leaves = [t.requires_grad_(True) for t in leaves]
    y, s = pss.selective_scan(*leaves, chunk=chunk)
    ((y.float() * torch.from_numpy(wy)).sum()
     + (s * torch.from_numpy(ws)).sum()).backward()
    tol = FP32 if dtype == "float32" else BF16
    for name, t, w in zip("x dt A B C".split(), leaves, want):
        _close(t.grad, w, tol, name)


# ------------------------------------------------- the hybrid training
def _port_config(jcfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg) if f.name in names})


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _hybrid_pair(seed=0, **kw):
    """A seeded fp32 JAX tiny hybrid ("SSA" over 3 layers) and the port's
    copy of it on the CPU, both in training mode."""
    kw = {"num_hidden_layers": 3, "layer_pattern": "SSA", **kw}
    paddle.seed(seed)
    jcfg = jax_ssm_tiny(**kw)
    jm = JaxHybrid(jcfg)
    pm = HybridSSMForCausalLM(_port_config(jcfg, SSMConfig), device="cpu")
    load_jax_state(pm, _state(jm))
    return jm, pm


def _llama_pair(seed, **kw):
    paddle.seed(seed)
    jcfg = jax_llama.LlamaConfig(**kw)
    jm = jax_llama.LlamaForCausalLM(jcfg)
    pm = LlamaForCausalLM(_port_config(jcfg, LlamaConfig), device="cpu")
    load_jax_state(pm, _state(jm))
    return jm, pm


def _jax_step(jm, ids):
    loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    loss.backward()
    return float(loss.numpy()), {n: p.grad for n, p in jm.named_parameters()}


def _port_step(pm, ids):
    loss, _ = pm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def test_hybrid_step_matches_jax_fp32():
    """One step of the fp32 tiny hybrid (s=40, no multiple of the chunk):
    the loss and every parameter's gradient against the JAX model's."""
    jm, pm = _hybrid_pair(seed=11)
    ids = np.random.RandomState(3).randint(0, 256, size=(2, 40)) \
        .astype("int32")
    jl, jg = _jax_step(jm, ids)
    kernels.reset_launch_counts()
    pl, pg = _port_step(pm, ids)
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert set(pg) == set(jg)
    for name, g in pg.items():
        _close(g, jg[name], FP32, name)


def test_hybrid_three_adamw_steps_match_jax():
    """Three AdamW steps (lr 1e-3, wd 0.1) of the fp32 tiny hybrid under
    each side's ``jit.to_static``: the losses at rtol 1e-5."""
    jm, pm = _hybrid_pair(seed=12)
    ids = np.random.RandomState(4).randint(0, 256, size=(2, 24)) \
        .astype("int32")
    jopt = jax_optimizer.AdamW(learning_rate=1e-3, weight_decay=0.1,
                               parameters=jm.parameters())
    popt = pt_optimizer.AdamW(learning_rate=1e-3, weight_decay=0.1,
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

    jl = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(3)]
    pl = [float(pstep(torch.from_numpy(ids))) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pl[2] < pl[0]


# ------------------------------------------------------------ recompute
_LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256)
# bench.py:131-136, the MoE bench's CPU configuration
_MOE = dict(vocab_size=512, hidden_size=128, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=8, max_position_embeddings=256,
            moe_num_experts=4, moe_capacity_factor=2.0)


def _recompute_pairs(kind):
    """(JAX, port) without recompute and (JAX, port) with it, all from the
    same seed, and a batch."""
    rs = np.random.RandomState({"dense": 5, "moe": 6, "hybrid": 7}[kind])
    if kind == "hybrid":
        pairs = [_hybrid_pair(seed=13, recompute=rc) for rc in (False, True)]
        vocab = 256
    else:
        kw = _LLAMA if kind == "dense" else _MOE
        pairs = [_llama_pair(21, recompute=rc, **kw) for rc in (False, True)]
        vocab = kw["vocab_size"]
    return pairs, rs.randint(0, vocab, size=(2, 20)).astype("int32")


def _aux(pm):
    return [float(l.mlp.gate.get_loss()) for l in pm.llama.layers
            if hasattr(l, "mlp") and hasattr(l.mlp, "gate")]


@pytest.mark.parametrize("kind", ["dense", "moe", "hybrid"])
def test_recompute_parity(kind):
    """A step with ``recompute`` against the same step without it (the
    reference's tolerance; measured bitwise on the CPU) and against the JAX
    model with ``recompute=True`` (the fp32 tier). The MoE Llama's loss
    carries each layer's aux loss, and ``gate.get_loss()`` reads the
    forward's value after the step, not the replay's."""
    ((_, plain), (jm, rec)), ids = _recompute_pairs(kind)
    assert rec.config.recompute and rec.training
    pl, pg = _port_step(plain, ids)
    rl, rg = _port_step(rec, ids)
    np.testing.assert_allclose(rl, pl, rtol=1e-5)
    for name, g in rg.items():
        np.testing.assert_allclose(_f64(g), _f64(pg[name]), **RECOMPUTE,
                                   err_msg=name)
    jl, jg = _jax_step(jm, ids)
    np.testing.assert_allclose(rl, jl, rtol=1e-5)
    for name, g in rg.items():
        _close(g, jg[name], FP32, name)
    if kind == "moe":
        aux = _aux(rec)
        assert len(aux) == 2 and all(a > 0 for a in aux)
        assert aux == _aux(plain)
        for layer in rec.llama.layers:
            assert layer.mlp.gate.get_loss().requires_grad


def test_recompute_replays_the_scan_bit_for_bit():
    """With ``recompute`` the backward replays each SSM layer: the scan
    runs twice a step, the replay's y and state are the forward's bits, and
    a model in eval mode does not recompute."""
    (_, (_, rec)), ids = _recompute_pairs("hybrid")
    outs, twin = [], pss._scan_reference

    def recording(*a, **kw):
        out = twin(*a, **kw)
        outs.append([t.detach().clone() for t in out[:2]])
        return out
    pss._scan_reference = recording
    try:
        _port_step(rec, ids)
        assert len(outs) == 2 * 2          # two SSM layers, each replayed
        for fwd, replay in ((outs[0], outs[3]), (outs[1], outs[2])):
            assert all(torch.equal(a, b) for a, b in zip(fwd, replay))
        outs.clear()
        rec.eval()
        rec(torch.from_numpy(ids), labels=torch.from_numpy(ids))
        assert len(outs) == 2
    finally:
        pss._scan_reference = twin
        rec.train()


def test_recompute_takes_callables_and_kwargs():
    """``recompute`` over a plain callable with keyword arguments: the
    same value and gradient as the call itself, for either
    ``use_reentrant``."""
    x = torch.from_numpy(np.random.RandomState(8).randn(5, 3)
                         .astype(np.float32))

    def f(a, scale=1.0):
        return (a.sin() * scale).exp()

    want_x = x.clone().requires_grad_(True)
    f(want_x, scale=0.5).sum().backward()
    for reentrant in (True, False):
        got_x = x.clone().requires_grad_(True)
        out = recompute(f, got_x, scale=0.5, use_reentrant=reentrant)
        out.sum().backward()
        assert torch.equal(out, f(x, scale=0.5))
        assert torch.equal(got_x.grad, want_x.grad)
