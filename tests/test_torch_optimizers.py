"""The port's optimizer plane against the JAX package's.

Every optimizer takes the same parameters and the same fixed gradients
(numpy, from a seed) on both sides, for three steps, in fp32, in bf16 and
in bf16 with ``multi_precision`` master weights, with and without weight
decay; then the options (AMSGrad, ``apply_decay_param_fun``, Lamb's
exclusion, Nesterov, centered RMSProp), gradient merge, LBFGS, the state
dicts and ``load_jax_optimizer_state``, the update's freedom from host
syncs, and the card phase's recipe on a tiny Llama. Tolerances are
``tests/op_harness.py``'s tiers: fp32 rtol 1e-5 / atol 1e-6, bf16 2e-2.
"""

import contextlib
import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jax_nn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.models import llama as jax_llama
from paddle_tpu_torch import nn as pt_nn
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import (load_jax_optimizer_state,
                                      load_jax_state, to_torch)

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)
TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
            max_position_embeddings=256)
MODES = ("fp32", "bf16", "bf16_mp")
NAMES = ("SGD", "Momentum", "Adagrad", "Adadelta", "Adam", "AdamW",
         "Adamax", "Lamb", "RMSProp", "Rprop", "ASGD", "NAdam", "RAdam")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    if isinstance(x, JTensor):
        x = x._data
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _as(arr, dtype):
    """numpy fp32 -> numpy of ``dtype`` (bf16 as ml_dtypes), rounded as
    JAX rounds."""
    return np.asarray(jnp.asarray(arr, jnp.float32).astype(dtype))


def _kwargs(name, decay):
    """The constructor options of ``name`` besides the LR: weight decay
    0.1 where the optimizer takes one (Lamb's own coefficient; Rprop has
    none, so its decay case narrows the step-size range instead)."""
    if name == "Lamb":
        return dict(lamb_weight_decay=0.1 if decay else 0.0)
    if name == "Rprop":
        return dict(learning_rate_range=(1e-4, 2e-2)) if decay else {}
    if name == "AdamW":
        return dict(weight_decay=0.1 if decay else 0.0)
    return dict(weight_decay=0.1) if decay else {}


class _Named(torch.nn.Parameter):
    """A parameter with a settable ``name``, as Paddle parameters have
    (a torch tensor's own ``name`` is read-only and None)."""
    name = None


def _pair(shapes, dtypes, seed=0, names=None):
    """JAX and port parameters with equal values: ``shapes[i]`` in
    ``dtypes[i]``, named ``names[i]`` if given."""
    rng = np.random.RandomState(seed)
    jps, pps = [], []
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        arr = _as(0.5 * rng.randn(*shape), dt)
        jp = paddle.to_tensor(arr, stop_gradient=False)
        pp = (torch.nn.Parameter if names is None else _Named)(to_torch(arr))
        if names is not None:
            jp.name = pp.name = names[i]
        jps.append(jp)
        pps.append(pp)
    return jps, pps


def _grads(rng, params_np):
    return [rng.randn(*p.shape).astype(np.float32) for p in params_np]


def _set_grads(jps, pps, grads):
    for jp, pp, g in zip(jps, pps, grads):
        ga = _as(g, jp._data.dtype)
        jp.grad = JTensor(jnp.asarray(ga))
        pp.grad = to_torch(ga)


def _steps(jopt, popt, jps, pps, steps=3, seed=1, skip=()):
    """``steps`` steps of fixed gradients; parameter ``i`` gets none at the
    steps in ``skip[i]``."""
    rng = np.random.RandomState(seed)
    for s in range(steps):
        grads = _grads(rng, pps)
        _set_grads(jps, pps, grads)
        for i, steps_without in enumerate(skip):
            if s in steps_without:
                jps[i].grad = None
                pps[i].grad = None
        jopt.step()
        popt.step()
        jopt.clear_grad()
        popt.clear_grad()


def _state_close(jopt, popt, tol, master_tol=None):
    """Equal state-dict keys, in order; every tensor within ``tol``
    (masters within ``master_tol``)."""
    js, ps = jopt.state_dict(), popt.state_dict()
    assert list(ps) == list(js)
    for key, jv in js.items():
        if key == "LR_Scheduler":
            assert ps[key] == jv
            continue
        t = master_tol if key.startswith("master") and master_tol else tol
        np.testing.assert_allclose(_np(ps[key]), _np(jv), **t, err_msg=key)


def _mode_setup(mode):
    dt = "float32" if mode == "fp32" else "bfloat16"
    # a weight in the mode's dtype and an fp32 norm-like vector
    return [(5, 4), (4,)], [dt, "float32"], mode == "bf16_mp"


@pytest.mark.parametrize("decay", [False, True], ids=["nodecay", "decay"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_jax(name, mode, decay):
    """Three steps: parameters, accumulators and masters against JAX's.
    fp32 at the fp32 tier; bf16 at the bf16 tier; with master weights the
    masters and (fp32) moments at the fp32 tier, the bf16 parameter at the
    bf16 tier, and each parameter is its master rounded to bf16."""
    shapes, dtypes, mp = _mode_setup(mode)
    jps, pps = _pair(shapes, dtypes)
    kw = dict(_kwargs(name, decay), multi_precision=mp)
    jopt = getattr(jax_optimizer, name)(learning_rate=1e-2, parameters=jps,
                                        **kw)
    popt = getattr(pt_optimizer, name)(learning_rate=1e-2, parameters=pps,
                                       **kw)
    _steps(jopt, popt, jps, pps)
    tol = FP32 if mode != "bf16" else BF16
    for jp, pp in zip(jps, pps):
        ptol = FP32 if pp.dtype == torch.float32 else BF16
        np.testing.assert_allclose(_np(pp), _np(jp), **ptol)
    _state_close(jopt, popt, tol)
    if mp:
        master = popt._master_weights[id(pps[0])]
        assert master.dtype == torch.float32
        assert torch.equal(pps[0].data, master.to(torch.bfloat16))
        for store in popt._accumulators.values():
            assert store[id(pps[0])].dtype == torch.float32
    else:
        for store in popt._accumulators.values():
            assert store[id(pps[0])].dtype == pps[0].dtype
    assert int(popt._step_count) == 3


OPTIONS = {
    "adamw_amsgrad": ("AdamW", dict(amsgrad=True, weight_decay=0.1)),
    "adam_amsgrad": ("Adam", dict(amsgrad=True, weight_decay=0.1)),
    "adamw_decay_fun": ("AdamW", dict(
        weight_decay=0.1, apply_decay_param_fun=lambda n: "norm" not in n)),
    "lamb_exclude": ("Lamb", dict(
        lamb_weight_decay=0.1,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)),
    "momentum_nesterov": ("Momentum", dict(use_nesterov=True,
                                           weight_decay=0.1)),
    "rmsprop_centered": ("RMSProp", dict(centered=True, momentum=0.9)),
    "adagrad_init": ("Adagrad", dict(initial_accumulator_value=0.1)),
    "l2_regularizer": ("Momentum", dict(
        weight_decay=type("L2Decay", (), {"_coeff": 0.05})())),
}


@pytest.mark.parametrize("mode", ["fp32", "bf16_mp"])
@pytest.mark.parametrize("case", list(OPTIONS))
def test_optimizer_options_match_jax(case, mode):
    """The options beyond the defaults, on named parameters (the names
    reach ``apply_decay_param_fun`` and become the state-dict keys)."""
    name, kw = OPTIONS[case]
    shapes, dtypes, mp = _mode_setup(mode)
    jps, pps = _pair(shapes, dtypes, names=["linear_0.w_0", "norm.w_0"])
    jopt = getattr(jax_optimizer, name)(learning_rate=1e-2, parameters=jps,
                                        multi_precision=mp, **kw)
    popt = getattr(pt_optimizer, name)(learning_rate=1e-2, parameters=pps,
                                       multi_precision=mp, **kw)
    _steps(jopt, popt, jps, pps)
    for jp, pp in zip(jps, pps):
        ptol = FP32 if pp.dtype == torch.float32 else BF16
        np.testing.assert_allclose(_np(pp), _np(jp), **ptol)
    _state_close(jopt, popt, FP32)
    assert any(k.startswith("linear_0.w_0_") for k in popt.state_dict())


def test_adamw_lr_ratio_scales_the_step():
    """``lr_ratio(p)`` scales p's learning rate, as Paddle's AdamW does
    (the JAX package takes the option and leaves it unused): a ratio of
    0.5 gives the step of half the learning rate, and 1.0 the JAX one."""
    _, pps_a = _pair([(5, 4)], ["float32"])
    _, pps_b = _pair([(5, 4)], ["float32"])
    jps, pps_c = _pair([(5, 4)], ["float32"])
    a = pt_optimizer.AdamW(learning_rate=1e-2, parameters=pps_a,
                           lr_ratio=lambda p: 0.5)
    b = pt_optimizer.AdamW(learning_rate=5e-3, parameters=pps_b)
    c = pt_optimizer.AdamW(learning_rate=1e-2, parameters=pps_c,
                           lr_ratio=lambda p: 1.0)
    j = jax_optimizer.AdamW(learning_rate=1e-2, parameters=jps)
    rng = np.random.RandomState(3)
    for _ in range(2):
        g = rng.randn(5, 4).astype(np.float32)
        for ps in (pps_a, pps_b, pps_c):
            ps[0].grad = torch.from_numpy(g)
        jps[0].grad = JTensor(jnp.asarray(g))
        for o in (a, b, c, j):
            o.step()
    np.testing.assert_allclose(_np(pps_a[0]), _np(pps_b[0]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(_np(pps_c[0]), _np(jps[0]), **FP32)


def test_adamw_keeps_the_existing_defaults():
    """The port's AdamW before the base took options: moments in the
    parameter's dtype, decoupled decay 0.01 by default, no master."""
    _, pps = _pair([(5, 4), (4,)], ["bfloat16", "float32"])
    opt = pt_optimizer.AdamW(parameters=pps)
    assert opt._weight_decay == 0.01 and not opt._use_master_weights
    for p in pps:
        p.grad = torch.ones_like(p)
    opt.step()
    assert opt._acc("moment1", pps[0]).dtype == torch.bfloat16
    assert opt._master_weights == {}


# ----------------------------------------------------------- gradient merge
@pytest.mark.parametrize("avg", [True, False], ids=["avg", "sum"])
@pytest.mark.parametrize("k", [1, 3])
def test_gradient_merge_matches_jax(k, avg):
    """``GradientMergeOptimizer`` over AdamW with master weights and fp32
    master gradients, 6 micro-steps; the second parameter takes no
    gradient in micro-steps 1, 2 and 4, and the third none at all in the
    last window: it must keep its weights there (touched flags)."""
    jps, pps = _pair([(5, 4), (4,), (3, 2)],
                     ["bfloat16", "float32", "bfloat16"])
    kw = dict(learning_rate=1e-2, weight_decay=0.1, multi_precision=True)
    jopt = jax_optimizer.GradientMergeOptimizer(
        jax_optimizer.AdamW(parameters=jps, **kw), k_steps=k, avg=avg)
    popt = pt_optimizer.GradientMergeOptimizer(
        pt_optimizer.AdamW(parameters=pps, **kw), k_steps=k, avg=avg)
    _steps(jopt, popt, jps, pps, steps=6,
           skip=((), (1, 2, 4), (3, 4, 5)))
    for jp, pp in zip(jps, pps):
        ptol = FP32 if pp.dtype == torch.float32 else BF16
        np.testing.assert_allclose(_np(pp), _np(jp), **ptol)
    js, ps = jopt.state_dict(), popt.state_dict()
    assert set(ps) == set(js)
    for key, jv in js.items():
        np.testing.assert_allclose(_np(ps[key]), _np(jv), **FP32,
                                   err_msg=key)
    assert all(b.dtype == torch.float32 for b in popt._buffers.values())
    assert int(popt._step_count) == 6 // k


def test_gradient_merge_untouched_parameter_keeps_its_state():
    """A window in which a parameter takes no gradient leaves its weight
    and moments exactly as they were."""
    _, pps = _pair([(5, 4), (4,)], ["float32", "float32"])
    opt = pt_optimizer.GradientMergeOptimizer(
        pt_optimizer.AdamW(learning_rate=1e-2, parameters=pps), k_steps=2)
    for p in pps:
        p.grad = torch.ones_like(p)
    opt.step()
    opt.step()
    before = pps[1].detach().clone(), opt._acc("moment1", pps[1]).clone()
    for _ in range(2):
        pps[0].grad = torch.ones_like(pps[0])
        pps[1].grad = None
        opt.step()
    assert torch.equal(pps[1].detach(), before[0])
    assert torch.equal(opt._acc("moment1", pps[1]), before[1])


# -------------------------------------------------------------------- LBFGS
@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    """Least squares ``|A x - b|^2`` over two parameters: two LBFGS steps
    of up to 20 iterations each, losses and solutions against JAX's."""
    rng = np.random.RandomState(5)
    a = rng.randn(12, 6).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    jps, pps = _pair([(4,), (2,)], ["float32", "float32"], seed=6)
    kw = dict(learning_rate=1.0, history_size=5, max_iter=20,
              line_search_fn=line_search)
    jopt = jax_optimizer.LBFGS(parameters=jps, **kw)
    popt = pt_optimizer.LBFGS(parameters=pps, **kw)
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def jclosure():
        jopt.clear_grad()
        x = paddle.concat([jps[0], jps[1]])
        r = paddle.matmul(ja, x) - jb
        loss = (r * r).sum()
        loss.backward()
        return loss

    def pclosure():
        popt.clear_grad()
        r = ta @ torch.cat([pps[0], pps[1]]) - tb
        loss = (r * r).sum()
        loss.backward()
        return loss

    jl = [float(jopt.step(jclosure).numpy()) for _ in range(2)]
    pl = [float(popt.step(pclosure)) for _ in range(2)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-5)
    for jp, pp in zip(jps, pps):
        np.testing.assert_allclose(_np(pp), _np(jp), rtol=1e-4, atol=1e-5)
    x_star = np.linalg.lstsq(a, b, rcond=None)[0]
    got = np.concatenate([_np(p) for p in pps])
    np.testing.assert_allclose(got, x_star, rtol=1e-3, atol=1e-3)
    assert len(popt._s) == len(jopt._s)
    state = popt.state_dict()
    assert len(state["lbfgs_history"]["s"]) == len(popt._s)


# ----------------------------------------------------- state dicts on Llama
def _llamas(dtype, seed=31):
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


def _recipe(lib, params, clip):
    """The card phase's optimizer: Llama-2 AdamW with fp32 masters,
    global-norm clipping at 1.0, linear warmup into a cosine decay."""
    sched = lib.lr.LinearWarmup(lib.lr.CosineAnnealingDecay(3e-4, T_max=12),
                                warmup_steps=3, start_lr=0.0, end_lr=3e-4)
    opt = lib.AdamW(learning_rate=sched, beta1=0.9, beta2=0.95,
                    epsilon=1e-5, weight_decay=0.1, multi_precision=True,
                    grad_clip=clip(1.0), parameters=params)
    return opt, sched


def _jax_params(jm):
    return [(n, tuple(p.shape)) for n, p in jm.named_parameters()]


def _train_both(jm, pm, jopt, popt, jsched, psched, ids, steps):
    jl, pl = [], []
    jids, pids = paddle.to_tensor(ids), torch.from_numpy(ids)
    for _ in range(steps):
        loss, _ = jm(jids, labels=jids)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        jl.append(float(loss.numpy()))
        loss, _ = pm(pids, labels=pids)
        loss.backward()
        popt.step()
        popt.clear_grad()
        psched.step()
        pl.append(float(loss.detach()))
        assert float(popt._lr_tensor) == np.float32(psched())
    return np.asarray(jl), np.asarray(pl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_recipe_matches_jax(dtype):
    """The card phase's recipe (AdamW 0.9/0.95/1e-5, wd 0.1, masters,
    ClipGradByGlobalNorm(1.0), LinearWarmup into CosineAnnealingDecay)
    on a 2-layer tiny Llama for 5 steps: losses and parameters against
    JAX (fp32 at rtol 1e-5 for the losses and 1e-4 for the parameters,
    whose Adam steps divide by sqrt(v); bf16 at the bf16 tier), the LR
    tensor equal to the scheduler after every step, and equal state-dict
    keys."""
    jm, pm = _llamas(dtype)
    jopt, jsched = _recipe(jax_optimizer, jm.parameters(),
                           jax_nn.ClipGradByGlobalNorm)
    popt, psched = _recipe(pt_optimizer, pm.parameters(),
                           pt_nn.ClipGradByGlobalNorm)
    ids = np.random.RandomState(7).randint(0, 128, size=(2, 16)) \
        .astype("int32")
    jl, pl = _train_both(jm, pm, jopt, popt, jsched, psched, ids, 5)
    tol = dict(rtol=1e-5, atol=0) if dtype == "float32" else BF16
    np.testing.assert_allclose(pl, jl, **tol)
    ptol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else BF16
    jstate = jm.state_dict()
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(_np(p), _np(jstate[name]), **ptol,
                                   err_msg=name)
    js, ps = jopt.state_dict(), popt.state_dict()
    assert list(ps) == list(js)
    assert ps["LR_Scheduler"] == js["LR_Scheduler"]
    assert (dtype == "bfloat16") == any(k.startswith("master_weights.")
                                        for k in ps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_optimizer_state_continues_like_jax(dtype):
    """JAX trains the recipe 3 steps; the port loads its weights and its
    optimizer state (moments, masters, step, scheduler) into a fresh model
    and optimizer, and both continue 2 steps: losses, parameters, moments
    and masters against JAX's (tiers as in the recipe test)."""
    jm, pm = _llamas(dtype, seed=32)
    jopt, jsched = _recipe(jax_optimizer, jm.parameters(),
                           jax_nn.ClipGradByGlobalNorm)
    ids = np.random.RandomState(8).randint(0, 128, size=(2, 16)) \
        .astype("int32")
    jids = paddle.to_tensor(ids)
    for _ in range(3):
        loss, _ = jm(jids, labels=jids)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jsched.step()
    load_jax_state(pm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    popt, psched = _recipe(pt_optimizer, pm.parameters(),
                           pt_nn.ClipGradByGlobalNorm)
    np_state = {k: (v if k == "LR_Scheduler" else np.asarray(v.numpy()))
                for k, v in jopt.state_dict().items()}
    load_jax_optimizer_state(popt, pm, np_state, _jax_params(jm))
    assert psched.last_epoch == jsched.last_epoch == 3
    assert float(popt._lr_tensor) == np.float32(jsched())
    assert int(popt._step_count) == 3
    jl, pl = _train_both(jm, pm, jopt, popt, jsched, psched, ids, 2)
    tol = dict(rtol=1e-5, atol=0) if dtype == "float32" else BF16
    np.testing.assert_allclose(pl, jl, **tol)
    ptol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else BF16
    jstate = jm.state_dict()
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(_np(p), _np(jstate[name]), **ptol,
                                   err_msg=name)
    js, ps = jopt.state_dict(), popt.state_dict()
    assert list(ps) == list(js)
    for key in js:
        if key != "LR_Scheduler":
            np.testing.assert_allclose(_np(ps[key]), _np(js[key]), **ptol,
                                       err_msg=key)


def _loaded(seed=33):
    jm, pm = _llamas("bfloat16", seed=seed)
    jopt, _ = _recipe(jax_optimizer, jm.parameters(),
                      jax_nn.ClipGradByGlobalNorm)
    ids = paddle.to_tensor(np.zeros((1, 8), np.int32))
    loss, _ = jm(ids, labels=ids)
    loss.backward()
    jopt.step()
    np_state = {k: (v if k == "LR_Scheduler" else np.asarray(v.numpy()))
                for k, v in jopt.state_dict().items()}
    return jm, pm, np_state


def test_load_jax_optimizer_state_refuses_what_it_cannot_place():
    """A shuffled parameter order (of the model against JAX's, or of the
    optimizer against the model), an unknown key, a shape or dtype
    mismatch and a master for an optimizer without masters all raise, and
    nothing is written before the check."""
    jm, pm, np_state = _loaded()
    order = _jax_params(jm)
    swapped = [order[1], order[0]] + order[2:]
    popt, _ = _recipe(pt_optimizer, pm.parameters(),
                      pt_nn.ClipGradByGlobalNorm)
    with pytest.raises(ValueError, match="order differs"):
        load_jax_optimizer_state(popt, pm, np_state, swapped)
    shuffled = list(pm.parameters())
    shuffled[0], shuffled[1] = shuffled[1], shuffled[0]
    sopt, _ = _recipe(pt_optimizer, shuffled, pt_nn.ClipGradByGlobalNorm)
    with pytest.raises(ValueError, match="model's order"):
        load_jax_optimizer_state(sopt, pm, np_state, order)
    with pytest.raises(KeyError, match="not a state key"):
        load_jax_optimizer_state(popt, pm, dict(np_state, param_0_velocity=
                                                np_state["param_0_moment1"]),
                                 order)
    with pytest.raises(ValueError, match="param_0_moment1"):
        load_jax_optimizer_state(popt, pm, dict(
            np_state, param_0_moment1=np_state["param_0_moment1"][:3]),
            order)
    with pytest.raises(ValueError, match="param_2_moment2"):
        load_jax_optimizer_state(popt, pm, dict(
            np_state, param_2_moment2=np_state["param_2_moment2"]
            .astype(np.float16)), order)
    plain = pt_optimizer.AdamW(parameters=pm.parameters(),
                               learning_rate=1e-3)
    state = {k: v for k, v in np_state.items()
             if k.startswith("master_weights.")}
    with pytest.raises(KeyError, match="no master"):
        load_jax_optimizer_state(plain, pm, state, order)
    assert popt._pending_state == {} and plain._pending_state == {}


def test_state_dict_round_trip_resumes_exactly():
    """The port's own ``state_dict`` (cloned) after 2 steps, loaded into a
    fresh optimizer over a copy of the weights, continues 2 steps bit for
    bit like the uninterrupted optimizer."""
    _, pps = _pair([(5, 4), (4,)], ["bfloat16", "float32"])
    opt, sched = _recipe(pt_optimizer, pps, pt_nn.ClipGradByGlobalNorm)
    rng = np.random.RandomState(9)
    grads = [_grads(rng, pps) for _ in range(4)]

    def run(o, s, ps, gs):
        for g in gs:
            for p, x in zip(ps, g):
                p.grad = to_torch(_as(x, "bfloat16")).to(p.dtype)
            o.step()
            o.clear_grad()
            s.step()

    run(opt, sched, pps, grads[:2])
    saved = {k: (v if k == "LR_Scheduler" else v.clone())
             for k, v in opt.state_dict().items()}
    copies = [torch.nn.Parameter(p.detach().clone()) for p in pps]
    run(opt, sched, pps, grads[2:])
    opt2, sched2 = _recipe(pt_optimizer, copies, pt_nn.ClipGradByGlobalNorm)
    opt2.set_state_dict(saved)
    assert set(opt2._pending_state) == {k for k in saved if k not in (
        "global_step", "LR_Scheduler")}
    run(opt2, sched2, copies, grads[2:])
    for a, b in zip(pps, copies):
        assert torch.equal(a, b)
    for key, v in opt.state_dict().items():
        if key == "LR_Scheduler":
            assert opt2.state_dict()[key] == v
        else:
            assert torch.equal(opt2.state_dict()[key], v), key


# ---------------------------------------------------------- no host syncs
@contextlib.contextmanager
def _no_host_reads():
    """Any read of a tensor's value to the host raises inside."""
    def refuse(*a, **k):
        raise AssertionError("host sync on the update path")
    with contextlib.ExitStack() as stack:
        for attr in ("item", "__bool__", "__float__", "__int__",
                     "__index__", "tolist", "numpy"):
            stack.enter_context(mock.patch.object(torch.Tensor, attr,
                                                  refuse))
        yield


@pytest.mark.parametrize("name", ["AdamW", "RAdam", "SGD", "Lamb"])
def test_update_path_makes_no_host_sync(name):
    """With every host read of a tensor refused: the clip (global norm and
    per-tensor norm), the scheduler's push into the LR tensor and the
    update (RAdam's rectification on both sides of its branch) run, and a
    read is refused (the guard works)."""
    _, pps = _pair([(5, 4), (4,)], ["bfloat16", "float32"])
    for clip in (pt_nn.ClipGradByGlobalNorm(0.5), pt_nn.ClipGradByNorm(0.5)):
        sched = pt_optimizer.lr.LinearWarmup(
            pt_optimizer.lr.CosineAnnealingDecay(1e-2, T_max=10),
            warmup_steps=2, start_lr=0.0, end_lr=1e-2)
        opt = getattr(pt_optimizer, name)(
            learning_rate=sched, parameters=pps, grad_clip=clip,
            multi_precision=True)
        for _ in range(8):          # RAdam rectifies from step 6
            for p in pps:
                p.grad = torch.randn(p.shape).to(p.dtype)
            with _no_host_reads():
                opt.step()
                sched.step()
                total = pt_nn.clip_grad_norm_(pps, 1.0)
            opt.clear_grad()
        assert torch.isfinite(total)
        for p in pps:
            assert torch.isfinite(p).all()
    with _no_host_reads(), pytest.raises(AssertionError, match="host sync"):
        float(pps[0].sum())


def test_exports_match_the_reference():
    """The optimizer package exports the reference's names but
    ``TrainGuard`` (ROADMAP.md A.12); ``nn`` exports the five clip APIs."""
    assert pt_optimizer.__all__ == [n for n in jax_optimizer.__all__
                                    if n != "TrainGuard"]
    for name in pt_optimizer.__all__:
        assert getattr(pt_optimizer, name) is not None
    clip = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
            "clip_grad_norm_", "clip_grad_value_"]
    assert set(clip) <= set(pt_nn.__all__)
    assert set(clip) <= set(jax_nn.__dict__)
