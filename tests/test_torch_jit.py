"""The port's ``jit.to_static`` against the JAX package's.

The reference traces a decorated function into one XLA program; the port
captures it into CUDA graphs. Here on the CPU there are no graphs: the
port's ``StaticFunction`` runs the function eagerly through the same
program cache, guards, host effects and staging slots, and these tests
hold what that machinery decides (program counts, guards, host values,
warnings) and what the step computes against ``paddle_tpu.jit``. Inputs
are made with numpy; weights cross with ``load_jax_state``. Tolerances:
losses at the fp32 tier (rtol 1e-5), gradients at rtol 1e-4 / atol 1e-6.

The port's cases of ``tests/test_jit.py`` leave out ``jit.save``/``load``
(not ported: ROADMAP.md A.3.2); the reference's dropout draws from its
global key, the port's from an explicit generator, so the RNG case holds
the port against its own eager sequence.
"""

import copy
import dataclasses
import inspect
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.models import llama as jax_llama
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch import jit as pt_jit
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch.jit import api as pt_api
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Linear
from paddle_tpu_torch.weights import load_jax_state

FP32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x.astype("float32").numpy(), np.float64)


def _llamas(seed=21):
    """A tiny fp32 JAX Llama and the port's copy of it."""
    paddle.seed(seed)
    jcfg = jax_llama.llama_tiny_config(dtype="float32", **TINY)
    jm = jax_llama.LlamaForCausalLM(jcfg)
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    pcfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name in names})
    pm = LlamaForCausalLM(pcfg, device="cpu")
    load_jax_state(pm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, pm


def _ids(seed=0, shape=(2, 24)):
    return np.random.RandomState(seed).randint(0, 128, size=shape)


class _PtMLP(torch.nn.Module):
    def __init__(self, jm):
        super().__init__()
        self.fc1 = Linear(8, 16, bias=True)
        self.fc2 = Linear(16, 4, bias=True)
        with torch.no_grad():
            for name in ("fc1", "fc2"):
                src, dst = getattr(jm, name), getattr(self, name)
                dst.weight.copy_(torch.tensor(src.weight.numpy()))
                dst.bias.copy_(torch.tensor(src.bias.numpy()))

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class _JaxMLP(jax_nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jax_nn.Linear(8, 16)
        self.fc2 = jax_nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


def _mlps(seed=42):
    paddle.seed(seed)
    jm = _JaxMLP()
    return jm, _PtMLP(jm)


def _xy(n=6, seed=7):
    rs = np.random.RandomState(seed)
    return ([rs.randn(4, 8).astype("float32") for _ in range(n)],
            [rs.randn(4, 4).astype("float32") for _ in range(n)])


# ------------------------------------------------- the reference's cases
def test_pure_fn_parity():
    rs = np.random.RandomState(0)
    x, y = rs.randn(4, 4).astype("float32"), rs.randn(4, 4).astype("float32")

    @paddle.jit.to_static
    def jf(a, b):
        return paddle.matmul(a, b) + paddle.nn.functional.relu(a).sum()

    @pt_jit.to_static
    def pf(a, b):
        return torch.matmul(a, b) + torch.relu(a).sum()

    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    px, py = torch.from_numpy(x), torch.from_numpy(y)
    want = _np(jf(jx, jy))
    for _ in range(3):      # first run, capture, replay
        np.testing.assert_allclose(_np(pf(px, py)), want, **FP32)
    jf(jx, jy)
    assert len(pf._cache) == len(jf._cache) == 1


@pytest.mark.parametrize("shapes", [[(2, 3), (2, 3), (4, 3)],
                                    [(2, 3), (4, 3), (2, 3), (4, 3)],
                                    [(5,), (5, 1), (1, 5)]])
def test_shape_specialization(shapes):
    @paddle.jit.to_static
    def jf(x):
        return x * 2.0

    @pt_jit.to_static
    def pf(x):
        return x * 2.0

    for s in shapes:
        a = np.ones(s, "float32")
        np.testing.assert_allclose(_np(pf(torch.from_numpy(a))),
                                   _np(jf(paddle.to_tensor(a))), **FP32)
    assert len(pf._cache) == len(jf._cache)
    assert len(pf.concrete_programs()) == len(jf.concrete_programs())


def test_static_python_values_key():
    @paddle.jit.to_static
    def jf(x, k):
        return x * k

    @pt_jit.to_static
    def pf(x, k):
        return x * k

    a = np.ones((3,), "float32")
    for k in (2.0, 3.0, 2.0):
        np.testing.assert_allclose(_np(pf(torch.from_numpy(a), k)),
                                   _np(jf(paddle.to_tensor(a), k)), **FP32)
    assert len(pf._cache) == len(jf._cache) == 2


@pytest.mark.parametrize("clip", [False, True])
def test_whole_train_step_parity_llama(clip):
    """A 2-layer Llama's AdamW step (with and without global-norm clip)
    under each side's ``to_static``: losses at rtol 1e-5 over 4 steps,
    one self-contained program on each side."""
    jm, pm = _llamas()
    jopt = jax_optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.1, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    popt = pt_optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.1, parameters=pm.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0) if clip else None)

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

    ids = _ids()
    jl = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(4)]
    pl = [float(pstep(torch.from_numpy(ids))) for _ in range(4)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert len(pstep.concrete_programs()) == \
        len(jstep.concrete_programs()) == 1
    assert pstep.concrete_programs()[0].self_contained
    assert jstep.concrete_programs()[0].self_contained


def test_whole_train_step_parity_mlp():
    """``tests/test_jit.py``'s MLP step: 6 AdamW steps over 6 batches,
    losses and parameters against JAX's ``to_static``."""
    jm, pm = _mlps()
    jopt = jax_optimizer.AdamW(learning_rate=1e-2, parameters=jm.parameters())
    popt = pt_optimizer.AdamW(learning_rate=1e-2, parameters=pm.parameters())

    @paddle.jit.to_static
    def jstep(x, y):
        loss = paddle.nn.functional.mse_loss(jm(x), y)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    @pt_jit.to_static
    def pstep(x, y):
        loss = torch.nn.functional.mse_loss(pm(x), y)
        loss.backward()
        popt.step()
        popt.clear_grad()
        return loss.detach()

    xs, ys = _xy()
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for x, y in zip(xs, ys)]
    pl = [float(pstep(torch.from_numpy(x), torch.from_numpy(y)))
          for x, y in zip(xs, ys)]
    np.testing.assert_allclose(pl, jl, rtol=2e-5, atol=1e-6)
    for name in ("fc1", "fc2"):
        for attr in ("weight", "bias"):
            np.testing.assert_allclose(
                _np(getattr(getattr(pm, name), attr)),
                _np(getattr(getattr(jm, name), attr)), rtol=2e-4, atol=1e-6)


def test_differentiable_region_llama():
    """``to_static(model)`` with the backward outside: the port's
    gradients against JAX's region's, rtol 1e-4 / atol 1e-6; the port's
    program is a region (not self-contained)."""
    jm, pm = _llamas(seed=3)
    sj, sp = paddle.jit.to_static(jm), pt_jit.to_static(pm)
    assert sp is pm and isinstance(pm.forward, pt_jit.StaticFunction)
    ids = _ids(1)
    jx, px = paddle.to_tensor(ids), torch.from_numpy(ids)
    for _ in range(2):         # the second call is the captured one
        jl = (sj(jx).astype("float32") ** 2).mean()
        pl = (sp(px).float() ** 2).mean()
    jl.backward()
    pl.backward()
    np.testing.assert_allclose(float(pl), float(jl.numpy()), **FP32)
    jstate = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jstate[name].grad),
                                   err_msg=name, **GRAD)
    prog, = pm.forward.concrete_programs()
    assert not prog.self_contained


def test_differentiable_region_input_grad():
    """A region's gradient reaches its input too."""
    jm, pm = _mlps(seed=5)
    sp = pt_jit.to_static(pm)
    x = np.random.RandomState(2).randn(4, 8).astype("float32")
    grads = []
    for _ in range(3):
        px = torch.from_numpy(x).requires_grad_(True)
        sp(px).square().sum().backward()
        grads.append(px.grad.clone())
    jx = paddle.to_tensor(x, stop_gradient=False)
    (jm(jx) ** 2).sum().backward()
    for g in grads:
        np.testing.assert_allclose(_np(g), _np(jx.grad), **GRAD)


def test_rng_draws_follow_the_eager_sequence():
    """Draws from an explicit generator inside the function differ call
    to call and are the eager sequence from the same seed."""
    gen = torch.Generator().manual_seed(11)

    @pt_jit.to_static
    def f(x):
        return x * torch.rand(x.shape, generator=gen)

    x = torch.ones(128)
    got = [f(x) for _ in range(4)]
    ref_gen = torch.Generator().manual_seed(11)
    want = [x * torch.rand(x.shape, generator=ref_gen) for _ in range(4)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[2], got[3])


def test_enable_toggle():
    @paddle.jit.to_static
    def jf(x):
        return x + 1.0

    @pt_jit.to_static
    def pf(x):
        return x + 1.0

    paddle.jit.enable_to_static(False)
    pt_jit.enable_to_static(False)
    try:
        out = pf(torch.zeros(2))
        jout = jf(paddle.to_tensor(np.zeros((2,), "float32")))
        assert len(pf._cache) == len(jf._cache) == 0
    finally:
        paddle.jit.enable_to_static(True)
        pt_jit.enable_to_static(True)
    np.testing.assert_allclose(_np(out), _np(jout))
    pf(torch.zeros(2))
    assert len(pf._cache) == 1


def test_nested_capture():
    jm, pm = _mlps(seed=5)
    jm.eval()
    pm.eval()
    jinner, pinner = paddle.jit.to_static(jm), pt_jit.to_static(pm)
    x = np.random.RandomState(3).randn(2, 8).astype("float32")
    jx, px = paddle.to_tensor(x), torch.from_numpy(x)
    with paddle.no_grad(), torch.no_grad():
        for _ in range(2):
            jinner(jx)
            pinner(px)

        @pt_jit.to_static
        def outer(t):
            return pinner(t) + 1.0

        got = [outer(px) for _ in range(3)]
        want = jinner(jx).numpy() + 1.0
    for a in got:
        np.testing.assert_allclose(_np(a), want, **FP32)
    # the inner function ran inline: its own cache is what its own calls
    # made, and the outer program guards the inner's module too
    assert len(pinner.forward._cache) == 1
    prog, = outer.concrete_programs()
    assert any(ref() is pm for ref, _ in prog.mode_guard)


def test_train_eval_mode_guard():
    paddle.seed(9)
    jseq = jax_nn.Sequential(jax_nn.Linear(8, 8), jax_nn.Dropout(0.5))
    pseq = torch.nn.Sequential(Linear(8, 8, bias=True), torch.nn.Dropout(0.5))
    with torch.no_grad():
        pseq[0].weight.copy_(torch.from_numpy(jseq[0].weight.numpy()))
        pseq[0].bias.copy_(torch.from_numpy(jseq[0].bias.numpy()))

    @paddle.jit.to_static
    def jinfer(x):
        return jseq(x)

    @pt_jit.to_static
    def pinfer(x):
        return pseq(x)

    x = np.ones((4, 8), "float32")
    jx, px = paddle.to_tensor(x), torch.from_numpy(x)
    for seq in (jseq, pseq):
        seq.train()
    for _ in range(2):
        jinfer(jx)
        pinfer(px)
    for seq in (jseq, pseq):
        seq.eval()
    out, out2 = pinfer(px), pinfer(px)
    assert torch.equal(out, out2)
    np.testing.assert_allclose(_np(out), _np(jinfer(jx)), **FP32)
    jinfer(jx)
    assert len(pinfer.concrete_programs()) == \
        len(jinfer.concrete_programs()) == 2
    # back to train mode: the first program again, no third
    pseq.train()
    pinfer(px)
    assert len(pinfer.concrete_programs()) == 2


def test_leaf_layer_mode_guard():
    d = pt_jit.to_static(torch.nn.Dropout(0.5))
    x = torch.ones(128)
    d.train()
    d(x)
    d(x)
    d.eval()
    assert torch.equal(d(x), torch.ones(128))
    assert len(d.forward.concrete_programs()) == 2


def test_raw_tensor_output_not_baked():
    @pt_jit.to_static
    def f(x):
        return {"twice": x * 2.0, "n": 3}

    f(torch.ones(3))
    f(torch.ones(3))
    b = f(torch.full((3,), 5.0))
    assert torch.equal(b["twice"], torch.full((3,), 10.0)) and b["n"] == 3


# ------------------------------------------------------ the port's cases
def _warmup_cosine(lr_mod):
    return lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(3e-3, T_max=12),
                               warmup_steps=3, start_lr=0.0, end_lr=3e-3)


def test_scheduler_inside_step_lr_sequence():
    """A scheduler stepped inside the step (warmup 3 into cosine 12) for
    13 steps: after every step the port's LR tensor is the reference's
    eager value (as float32) and its scheduler's. The reference's own
    ``to_static`` runs the scheduler's host arithmetic only while it
    traces and repeats one LR after that (ROADMAP.md C); the port stages
    the value into every replay."""
    jm, pm = _mlps(seed=1)
    jsched, psched = _warmup_cosine(jax_optimizer.lr), \
        _warmup_cosine(pt_optimizer.lr)
    jopt = jax_optimizer.AdamW(learning_rate=jsched,
                               parameters=jm.parameters())
    popt = pt_optimizer.AdamW(learning_rate=psched,
                              parameters=pm.parameters())

    def jstep(x):
        loss = (jm(x) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        return loss

    @pt_jit.to_static
    def pstep(x):
        loss = pm(x).square().mean()
        loss.backward()
        popt.step()
        popt.clear_grad()
        psched.step()
        return loss.detach()

    x = np.random.RandomState(4).randn(4, 8).astype("float32")
    jl, pl, want, got, sched = [], [], [], [], []
    for _ in range(13):
        jl.append(float(jstep(paddle.to_tensor(x)).numpy()))
        want.append(float(jopt._lr_tensor.numpy()))
        pl.append(float(pstep(torch.from_numpy(x))))
        got.append(float(popt._lr_tensor))
        sched.append(float(np.float32(psched())))
    assert got == want == sched
    np.testing.assert_allclose(pl, jl, rtol=2e-5, atol=1e-6)
    prog, = pstep.concrete_programs()
    assert len(prog.slots) == 1 and len(prog.effects) == 2


def test_set_lr_inside_step_is_staged():
    pm = _mlps()[1]
    popt = pt_optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())

    @pt_jit.to_static
    def step(x, lr):
        popt.set_lr(lr)
        loss = pm(x).sum()
        loss.backward()
        popt.step()
        popt.clear_grad()
        return popt._lr_tensor.clone()

    x = torch.ones(2, 8)
    assert [float(step(x, 0.5)) for _ in range(3)] == [0.5] * 3
    assert float(step(x, 0.25)) == 0.25
    assert len(step._cache) == 2


@pytest.mark.parametrize("k", [1, 4])
def test_gradient_merge_inside_step(k):
    """``GradientMergeOptimizer(AdamW, k)`` under each side's
    ``to_static`` for 8 steps: losses and parameters at the fp32 tier.
    The port's window is a host guard: at k 4 an accumulating and an
    applying program, at k 1 only the applying one; the reference's
    traced window is one masked program."""
    jm, pm = _mlps(seed=2)
    jgm = jax_optimizer.GradientMergeOptimizer(
        jax_optimizer.AdamW(learning_rate=1e-2, parameters=jm.parameters()),
        k_steps=k)
    pgm = pt_optimizer.GradientMergeOptimizer(
        pt_optimizer.AdamW(learning_rate=1e-2, parameters=pm.parameters()),
        k_steps=k)

    @paddle.jit.to_static
    def jstep(x):
        loss = (jm(x) ** 2).mean()
        loss.backward()
        jgm.step()
        jgm.clear_grad()
        return loss

    @pt_jit.to_static
    def pstep(x):
        loss = pm(x).square().mean()
        loss.backward()
        pgm.step()
        pgm.clear_grad()
        return loss.detach()

    rs = np.random.RandomState(1)
    xs = [rs.randn(2, 8).astype("float32") for _ in range(8)]
    jl = [float(jstep(paddle.to_tensor(x)).numpy()) for x in xs]
    pl = [float(pstep(torch.from_numpy(x))) for x in xs]
    np.testing.assert_allclose(pl, jl, **FP32)
    for name in ("fc1", "fc2"):
        for attr in ("weight", "bias"):
            np.testing.assert_allclose(
                _np(getattr(getattr(pm, name), attr)),
                _np(getattr(getattr(jm, name), attr)), **FP32)
    progs = pstep.concrete_programs()
    assert len(progs) == (2 if k > 1 else 1)
    assert len(jstep.concrete_programs()) == 1
    assert pgm._count == 8 and not any(pgm._touched.values())


def test_fresh_outputs():
    """A kept output does not change under later calls."""
    pm = _mlps()[1]
    popt = pt_optimizer.SGD(learning_rate=0.1, parameters=pm.parameters())

    @pt_jit.to_static
    def step(x):
        loss = pm(x).square().mean()
        loss.backward()
        popt.step()
        popt.clear_grad()
        return loss.detach()

    x = torch.ones(2, 8)
    kept = [step(x) for _ in range(4)]
    vals = [float(v) for v in kept]
    step(x)
    assert [float(v) for v in kept] == vals
    assert len({id(v) for v in kept}) == 4
    assert vals[-1] < vals[0]


def test_uncapturable_warns_once():
    @pt_jit.to_static
    def f(x):
        pt_api.uncapturable("a host read of the loss")
        return x * 2

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        outs = [f(torch.ones(2)) for _ in range(4)]
    msgs = [str(w.message) for w in rec
            if "cannot be captured" in str(w.message)]
    assert len(msgs) == 1 and "a host read of the loss" in msgs[0]
    prog, = f.concrete_programs()
    assert not prog.captured and prog.reason == "a host read of the loss"
    assert all(torch.equal(o, torch.full((2,), 2.0)) for o in outs)


def test_lbfgs_step_runs_eagerly():
    pm = _mlps()[1]
    opt = pt_optimizer.LBFGS(learning_rate=1.0, max_iter=3,
                             parameters=pm.parameters())
    x = torch.ones(4, 8)

    @pt_jit.to_static
    def step():
        def closure():
            opt.clear_grad()
            loss = pm(x).square().mean()
            loss.backward()
            return loss
        return opt.step(closure)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        losses = [float(step()) for _ in range(3)]
    assert sum("LBFGS.step" in str(w.message) for w in rec) == 1
    assert "LBFGS.step" in step.concrete_programs()[0].reason
    assert losses[-1] <= losses[0]


def test_reduce_on_plateau_with_metric_runs_eagerly():
    sched = pt_optimizer.lr.ReduceOnPlateau(0.1, patience=0)

    @pt_jit.to_static
    def f(x):
        sched.step(x.sum())
        return x

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for v in (1.0, 2.0, 3.0):
            f(torch.full((1,), v))
    assert sum("ReduceOnPlateau" in str(w.message) for w in rec) == 1
    assert sched() < 0.1


def test_hook_met_at_capture_runs_each_call_once():
    """A step that meets the uncapturable hook only in the call that
    captures runs eagerly from then on, each call once: its parameters,
    scheduler epoch and LR are an eager twin's."""
    def build():
        torch.manual_seed(0)
        m = torch.nn.Linear(8, 4)
        sched = pt_optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
        return m, sched, pt_optimizer.SGD(learning_rate=sched,
                                          parameters=m.parameters())

    def step_of(m, sched, opt, calls):
        def step(x):
            calls.append(1)
            loss = m(x).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            if len(calls) == 2:
                pt_api.uncapturable("a read only the second call makes")
            return loss.detach()
        return step

    (m1, s1, o1), (m2, s2, o2) = build(), build()
    eager = step_of(m1, s1, o1, [])
    static = pt_jit.to_static(step_of(m2, s2, o2, []))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        for _ in range(4):
            assert torch.equal(eager(torch.ones(2, 8)),
                               static(torch.ones(2, 8)))
    assert s2.last_epoch == s1.last_epoch == 4
    assert float(o2._lr_tensor) == float(o1._lr_tensor)
    assert torch.equal(m1.weight, m2.weight)
    assert static.concrete_programs()[0].reason is not None


def test_analysis():
    @pt_jit.to_static
    def f(x):
        return x + 1

    for _ in range(3):
        f(torch.ones(2))
    assert f.cost_analysis() is None
    assert f.concrete_programs()[0].cost_analysis() is None
    assert f.memory_analysis() is None      # no graph on the CPU


def test_storage_guard_param_data():
    """Replacing a parameter's storage makes a new program; the step goes
    on equal to the eager one."""
    def build():
        torch.manual_seed(0)
        m = torch.nn.Linear(8, 4)
        return m, pt_optimizer.SGD(learning_rate=0.1,
                                   parameters=m.parameters())

    m1, o1 = build()
    m2, o2 = build()

    def step_of(m, o):
        def step(x):
            loss = m(x).square().mean()
            loss.backward()
            o.step()
            o.clear_grad()
            return loss.detach()
        return step

    eager, static = step_of(m1, o1), pt_jit.to_static(step_of(m2, o2))
    x = torch.ones(2, 8)
    for i in range(6):
        if i == 3:
            for m in (m1, m2):
                m.weight.data = m.weight.data.clone() * 0.5
        assert torch.equal(eager(x), static(x))
    assert len(static.concrete_programs()) == 2


def test_identity_guard_new_optimizer():
    """A new optimizer bound to the name the step reads re-captures."""
    torch.manual_seed(0)
    m = torch.nn.Linear(8, 4)
    box = {"opt": pt_optimizer.SGD(learning_rate=0.1,
                                   parameters=m.parameters())}
    opt = box["opt"]

    @pt_jit.to_static
    def step(x):
        loss = m(x).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    x = torch.ones(2, 8)
    step(x)
    step(x)
    opt = pt_optimizer.SGD(learning_rate=0.2,   # noqa: F841 (closure)
                           parameters=m.parameters())
    step(x)
    assert len(step.concrete_programs()) == 2


def test_flags_and_grad_mode_key():
    @pt_jit.to_static
    def f(x):
        return x * 2

    x = torch.ones(2)
    f(x)
    old = pt_flags.flag("pallas_fused_block")
    pt_flags.set_flags({"pallas_fused_block": "off" if old != "off"
                        else "on"})
    try:
        f(x)
    finally:
        pt_flags.set_flags({"pallas_fused_block": old})
    f(x)
    with torch.no_grad():
        f(x)
    assert len(f._cache) == 3


def test_method_binding():
    class Net(torch.nn.Module):
        def __init__(self, scale):
            super().__init__()
            self.scale = scale

        @pt_jit.to_static
        def forward(self, x):
            return x * self.scale

    a, b = Net(2.0), Net(3.0)
    x = torch.ones(2)
    for _ in range(3):
        assert torch.equal(a(x), x * 2) and torch.equal(b(x), x * 3)
    assert a.forward is a.forward and a.forward is not b.forward
    assert len(a.forward._cache) == len(b.forward._cache) == 1
    assert isinstance(Net.forward, pt_jit.StaticFunction)


def test_function_rollback_and_deepcopy():
    pm = _mlps()[1]
    orig = pm.forward
    sp = pt_jit.to_static(pm)
    assert sp.forward.function == orig and sp.forward.rollback() == orig
    x = torch.ones(2, 8)
    with torch.no_grad():
        y = [sp(x) for _ in range(3)]
        twin = copy.deepcopy(sp)
        assert twin.forward._cache == {}
        assert torch.equal(twin(x), y[0])
    assert twin.forward.function.__self__ is twin


def test_no_grad_forward_is_self_contained():
    pm = _mlps()[1]
    sp = pt_jit.to_static(pm)
    x = torch.ones(2, 8)
    with torch.no_grad():
        outs = [sp(x) for _ in range(3)]
    prog, = sp.forward.concrete_programs()
    assert prog.self_contained and not outs[-1].requires_grad


def test_public_surface_matches_reference():
    assert set(pt_jit.__all__) == set(paddle.jit.__all__)
    for name in ("to_static", "InputSpec", "enable_to_static",
                 "not_to_static", "ignore_module", "set_code_level",
                 "set_verbosity"):
        ours = inspect.signature(getattr(pt_jit, name)).parameters
        ref = inspect.signature(getattr(paddle.jit, name)).parameters
        assert list(ours) == list(ref), name
        assert [p.default for p in ours.values()] == \
            [p.default for p in ref.values()], name
    spec = pt_jit.InputSpec([None, 8], "bfloat16", name="x")
    assert spec.dtype == torch.bfloat16 and spec.shape == (None, 8)
    assert "x" in repr(spec)


@pytest.mark.parametrize("call", [
    lambda: pt_jit.save(None, "p"), lambda: pt_jit.load("p"),
    lambda: pt_jit.TranslatedLayer()])
def test_serialization_not_ported(call):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.3.2"):
        call()


def test_logging_levels_and_parity_no_ops():
    import logging
    pt_jit.set_verbosity(1)
    pt_jit.set_code_level(1)
    assert logging.getLogger("paddle_tpu_torch.jit").level == logging.DEBUG
    assert logging.getLogger("paddle_tpu_torch.jit.dy2static").level == \
        logging.DEBUG
    pt_jit.set_verbosity(0)
    pt_jit.set_code_level(0)
    assert logging.getLogger("paddle_tpu_torch.jit").level == logging.WARNING

    def g(x):
        return x
    assert pt_jit.not_to_static(g) is g and pt_jit.not_to_static()(g) is g
    assert pt_jit.ignore_module([torch]) is None


def test_module_hook_released():
    """The global module pre-hook lives only while a step records."""
    from torch.nn.modules import module as tmod
    pm = _mlps()[1]
    before = len(tmod._global_forward_pre_hooks)
    sp = pt_jit.to_static(pm)
    with torch.no_grad():
        for _ in range(3):
            sp(torch.ones(2, 8))
    assert len(tmod._global_forward_pre_hooks) == before


def test_state_created_in_capture_is_refused():
    """State that only the capture creates would be baked: refused, as
    the reference refuses a retrace that touches unseen state."""
    torch.manual_seed(0)
    m = torch.nn.Linear(4, 4)
    opt = pt_optimizer.Adam(learning_rate=0.1, parameters=m.parameters())
    calls = []

    @pt_jit.to_static
    def step(x):
        calls.append(1)
        loss = m(x).sum()
        loss.backward()
        if len(calls) == 1:
            m.bias.grad = None       # the first run never makes its moments
        opt.step()
        opt.clear_grad()
        return loss.detach()

    step(torch.ones(2, 4))
    with pytest.raises(RuntimeError, match="state"):
        step(torch.ones(2, 4))


def test_launch_count_deltas_replayed(monkeypatch):
    """A replayed program adds the launches its capture counted; on the
    CPU the wrappers count none, so the counts stay put."""
    from paddle_tpu_torch.ops import kernels
    jm, pm = _llamas()
    opt = pt_optimizer.SGD(learning_rate=1e-3, parameters=pm.parameters())

    @pt_jit.to_static
    def step(x):
        loss, _ = pm(x, labels=x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    kernels.reset_launch_counts()
    for _ in range(3):
        step(torch.from_numpy(_ids()))
    assert sum(kernels.launch_counts().values()) == 0
    prog, = step.concrete_programs()
    assert prog.launch_delta == ()
    pt_api._add_launches((("rms_norm_fwd", 5),))
    assert kernels.launch_counts()["rms_norm_fwd"] == 5
    kernels.reset_launch_counts()


def test_port_package_root_exports_jit():
    assert pt.jit is pt_jit and pt.jit.to_static is pt_api.to_static
