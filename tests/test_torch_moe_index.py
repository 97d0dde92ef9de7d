"""The port's index-form and dense-route MoE paths against the JAX package.

``MoELayer`` under ``moe_grouped_gemm=off`` (the reference's index-form
scatter/vmap path), with any expert module the reference stacks (bias
``Linear``, Linear-GELU-Linear, a module that shares SwiGLU's parameter
names but computes something else), with a gate that gives only the dense
``route``, under ``recompute_interval``, in fp16 and bf16; the tiny MoE
Llama trained and served at ``off``; a dense-gate MoE Llama through the
eager engine; the flag rules. Inputs are made with numpy, weights by the
JAX side from a seed and carried across with ``load_jax_state``.
Tolerances are ``tests/op_harness.py``'s (fp32 rtol 1e-5 / atol 1e-6,
bf16 2e-2 / 2e-2) unless a test states its own; gradients' atol is scaled
by their largest magnitude.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as jax_moe
from paddle_tpu.inference import GenerationEngine as JaxEngine
from paddle_tpu.inference import GenerationRequest as JaxRequest
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.incubate.distributed.models import moe as pt_moe
from paddle_tpu_torch.incubate.distributed.models.moe import moe_a2a
from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
from paddle_tpu_torch.inference import engine as pt_engine
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import grouped_gemm as pgg
from paddle_tpu_torch.weights import load_jax_state, to_torch

from test_torch_moe import _grads_close, _models, _np, _train, flag_values

D, E = 16, 4
OFF = {"moe_grouped_gemm": "off"}
BF16 = dict(rtol=2e-2, atol=2e-2)


# ------------------------------------------------------------ the experts
class JaxGeluMLP(paddle.nn.Layer):
    """Linear-GELU-Linear with biases."""

    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(D, 2 * D)
        self.fc2 = paddle.nn.Linear(2 * D, D)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.gelu(self.fc1(x)))


class PtGeluMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = pnn.Linear(D, 2 * D, bias=True)
        self.fc2 = pnn.Linear(2 * D, D, bias=True)

    def forward(self, x):
        return self.fc2(torch.nn.functional.gelu(self.fc1(x)))


class JaxNamesakeMLP(paddle.nn.Layer):
    """SwiGLU's three bias-free weights, a GELU forward: no opt-in."""

    def __init__(self):
        super().__init__()
        self.gate_proj = paddle.nn.Linear(D, 2 * D, bias_attr=False)
        self.up_proj = paddle.nn.Linear(D, 2 * D, bias_attr=False)
        self.down_proj = paddle.nn.Linear(2 * D, D, bias_attr=False)

    def forward(self, x):
        return self.down_proj(paddle.nn.functional.gelu(self.gate_proj(x))
                              + self.up_proj(x))


class PtNamesakeMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.gate_proj = pnn.Linear(D, 2 * D)
        self.up_proj = pnn.Linear(D, 2 * D)
        self.down_proj = pnn.Linear(2 * D, D)

    def forward(self, x):
        return self.down_proj(torch.nn.functional.gelu(self.gate_proj(x))
                              + self.up_proj(x))


def _jax_swiglu():
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaMLP as JaxMLP
    return JaxMLP(JaxConfig(hidden_size=D, intermediate_size=2 * D))


def _pt_swiglu():
    cfg = LlamaConfig(hidden_size=D, intermediate_size=2 * D)
    return pt_llama.LlamaMLP(cfg, pt_llama._Init(cfg, torch.device("cpu"),
                                                 torch.Generator()))


EXPERTS = {
    "swiglu": (_jax_swiglu, _pt_swiglu),
    "linear": (lambda: paddle.nn.Linear(D, D),
               lambda: pnn.Linear(D, D, bias=True)),
    "gelu-mlp": (JaxGeluMLP, PtGeluMLP),
    "namesake": (JaxNamesakeMLP, PtNamesakeMLP),
}


# --------------------------------------------------------------- the gates
class JaxRoundRobinGate(jax_moe.BaseGate):
    """The reference test's custom gate with ONLY the dense interface
    (``tests/test_moe.py:370-400``)."""
    top_k = 1

    def route(self, scores, capacity):
        n, e = scores.shape
        idx = jnp.arange(n) % e
        slot = jnp.arange(n) // e
        combine = jnp.zeros((n, e, capacity), scores.dtype)
        combine = combine.at[jnp.arange(n), idx,
                             jnp.minimum(slot, capacity - 1)].set(1.0)
        return combine, combine > 0, jnp.zeros((), scores.dtype)


class PtRoundRobinGate(pt_moe.BaseGate):
    top_k = 1

    def route(self, scores, capacity):
        n, e = scores.shape
        rows = torch.arange(n)
        combine = torch.zeros((n, e, capacity), dtype=scores.dtype)
        combine[rows, rows % e, (rows // e).clamp(max=capacity - 1)] = 1.0
        return combine, combine > 0, torch.zeros((), dtype=scores.dtype)


class JaxDenseTop1Gate(jax_moe.BaseGate):
    """A dense-only gate that follows the scores: top-1 by probability,
    slots in arrival order, the dropped tokens' weight 0."""
    top_k = 1

    def route(self, scores, capacity):
        n, e = scores.shape
        probs = jnp.exp(scores - scores.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        idx = jnp.argmax(probs, -1)
        mask = (idx[:, None] == jnp.arange(e)[None, :]).astype(scores.dtype)
        pos = ((jnp.cumsum(mask, 0) - mask) * mask).sum(-1).astype(jnp.int32)
        w = jnp.where(pos < capacity, probs.max(-1), 0.0)
        combine = jnp.zeros((n, e, capacity), scores.dtype).at[
            jnp.arange(n), idx, jnp.minimum(pos, capacity - 1)].add(w)
        return combine, combine > 0, jnp.zeros((), scores.dtype)


class PtDenseTop1Gate(pt_moe.BaseGate):
    top_k = 1

    def route(self, scores, capacity):
        n, e = scores.shape
        probs = torch.exp(scores - scores.amax(-1, keepdim=True))
        probs = probs / probs.sum(-1, keepdim=True)
        idx = probs.argmax(-1)
        mask = (idx[:, None] == torch.arange(e)[None, :]).to(scores.dtype)
        pos = ((torch.cumsum(mask, 0) - mask) * mask).sum(-1).long()
        w = torch.where(pos < capacity, probs.amax(-1),
                        torch.zeros((), dtype=scores.dtype))
        combine = torch.zeros((n, e, capacity), dtype=scores.dtype)
        combine.index_put_((torch.arange(n), idx,
                            pos.clamp(max=capacity - 1)), w,
                           accumulate=True)
        return combine, combine > 0, torch.zeros((), dtype=scores.dtype)


# ----------------------------------------------------------------- helpers
def _pair(expert="swiglu", gate="gshard", cf=2.0, dtype=None, recompute=0,
          seed=12):
    """The JAX layer and the port's over the same weights. Every stacked
    bias gets random values (the JAX init leaves them zero)."""
    make_j, make_p = EXPERTS[expert]
    paddle.seed(seed)
    jgate, pgate = gate, gate
    if gate == "round-robin":
        jgate = JaxRoundRobinGate(D, E)
        pgate = PtRoundRobinGate(D, E, device="cpu")
    jl = jax_moe.MoELayer(D, [make_j() for _ in range(E)], gate=jgate,
                          capacity_factor=cf, recompute_interval=recompute)
    rs = np.random.RandomState(seed)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    for k in state:
        if k.endswith("bias"):
            state[k] = (rs.randn(*state[k].shape) * 0.5).astype(np.float32)
    jl.set_state_dict(state)
    pl = pt_moe.MoELayer(D, [make_p() for _ in range(E)], gate=pgate,
                         capacity_factor=cf, recompute_interval=recompute)
    if dtype is not None:
        jl.astype(dtype)
        pl.to(getattr(torch, dtype))
    load_jax_state(pl, {k: np.asarray(v.numpy())
                        for k, v in jl.state_dict().items()})
    return jl, pl


def _x(seed=13, shape=(2, 16, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_run(jl, x, mode="off", dtype=None):
    for p in jl.parameters():
        p.clear_gradient()
    with flag_values({"moe_grouped_gemm": mode}):
        jx = paddle.to_tensor(x, stop_gradient=False)
        jy = jl(jx if dtype is None else jx.astype(dtype))
        yf = jy.astype("float32")
        loss = (yf * yf).sum() + jl.gate.get_loss().astype("float32")
        loss.backward()
    grads = {n: p.grad for n, p in jl.named_parameters()}
    return jy, float(loss.numpy()), jx.grad, grads


def _pt_run(pl, x, dtype=None):
    pl.zero_grad(set_to_none=True)
    px = torch.from_numpy(x).requires_grad_(True)
    py = pl(px if dtype is None else px.to(getattr(torch, dtype)))
    loss = (py.float() ** 2).sum() + pl.gate.get_loss()
    loss.backward()
    # a parameter the loss does not reach (a round-robin gate's weight)
    # has no gradient in torch and a zero one in JAX
    return py, float(loss.detach()), px.grad, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in pl.named_parameters()}


def _check(jl, pl, x, mode="off", tol=None, dtype=None, aux=True):
    """The port's output, loss (with aux) and gradients of x, the gate and
    every stacked leaf against JAX at ``moe_grouped_gemm=mode``."""
    tol = tol or dict(rtol=1e-5, atol=1e-6)
    jy, jloss, jdx, jg = _jax_run(jl, x, mode, dtype)
    py, ploss, pdx, pg = _pt_run(pl, x, dtype)
    np.testing.assert_allclose(_np(py), _np(jy), rtol=tol["rtol"],
                               atol=tol["atol"])
    np.testing.assert_allclose(ploss, jloss, rtol=tol["rtol"])
    if aux:
        np.testing.assert_allclose(float(pl.gate.get_loss().detach()),
                                   float(jl.gate.get_loss().numpy()),
                                   rtol=tol["rtol"], atol=tol["atol"])
    assert set(pg) == set(jg)
    _grads_close([("x", pdx, jdx)] + [(n, pg[n], jg[n]) for n in pg],
                 rtol=tol["rtol"], atol=tol["atol"])
    return py, pdx, pg


# -------------------------------------------------------- the index form
@pytest.mark.parametrize("gate,cf", [("gshard", 1.0), ("gshard", 2.0),
                                     ("switch", 1.25), ("switch", 0.5),
                                     ("naive", 2.0), ("naive", 1.0)])
def test_index_form_matches_jax(gate, cf):
    """SwiGLU experts at ``moe_grouped_gemm=off`` on both sides: output,
    aux, loss and the gradients of x, the gate and the three stacked
    leaves, for each gate; cf 1.0 at top-2 (and switch at 0.5) overflows
    the capacity, so the drops and their masks must match too. No grouped
    GEMM runs."""
    jl, pl = _pair(gate=gate, cf=cf)
    kernels.reset_launch_counts()
    pgg_before = (pgg.launches, pgg.launches_gmm2)
    with flag_values(pt_values=OFF):
        _check(jl, pl, _x())
    assert (pgg.launches, pgg.launches_gmm2) == pgg_before


@pytest.mark.parametrize("expert", ["linear", "gelu-mlp"])
@pytest.mark.parametrize("mode", ["auto", "off"])
def test_any_expert_module_matches_jax(expert, mode):
    """Experts other than SwiGLU MLPs: bias ``Linear`` (the reference
    test's experts) and Linear-GELU-Linear, defined alike on both sides,
    vmapped through ``functional_call``. They take the index form whatever
    ``moe_grouped_gemm`` says, as in the reference; the stacked bias leaves
    carry their gradients."""
    jl, pl = _pair(expert=expert, cf=1.0)
    assert not pl._grouped_ok
    assert "stacked.bias" in dict(pl.named_parameters()) or \
        "stacked.fc1__bias" in dict(pl.named_parameters())
    with flag_values({"moe_grouped_gemm": mode},
                     {"moe_grouped_gemm": mode}):
        _check(jl, pl, _x(14))


def test_namesake_expert_is_not_run_as_swiglu():
    """An expert with ``gate_proj``/``up_proj``/``down_proj`` weights but a
    GELU forward and no ``supports_grouped_gemm``: under the default
    ``moe_grouped_gemm`` it takes the index form and gives JAX's result,
    not what the grouped SwiGLU forward would give on the same weights."""
    jl, pl = _pair(expert="namesake", cf=2.0)
    assert not pl._grouped_ok
    with flag_values({"moe_grouped_gemm": "on"},
                     {"moe_grouped_gemm": "auto"}):
        py, _, _ = _check(jl, pl, _x(15))
    # the same weights in SwiGLU experts: what the old name-only test
    # would have computed
    swiglu = pt_moe.MoELayer(D, [_pt_swiglu() for _ in range(E)])
    load_jax_state(swiglu, {k: v.detach().numpy()
                            for k, v in pl.state_dict().items()})
    assert swiglu._grouped_ok
    with torch.no_grad():
        wrong = swiglu(torch.from_numpy(_x(15)))
    assert not torch.allclose(wrong, py.detach(), rtol=1e-3, atol=1e-3)
    # the class opt-in restores the grouped path
    PtNamesakeMLP.supports_grouped_gemm = True
    try:
        assert pt_moe.MoELayer(D, [PtNamesakeMLP() for _ in range(E)]) \
            ._grouped_ok
    finally:
        del PtNamesakeMLP.supports_grouped_gemm


def test_dense_route_round_robin_gate_matches_jax():
    """The reference test's round-robin gate, which gives only ``route``:
    the dense dispatch and combine einsums around the vmapped bias-Linear
    experts; each token gets exactly its expert's output (capacity 4 keeps
    all 16 tokens), and the output and gradients match JAX's."""
    jl, pl = _pair(expert="linear", gate="round-robin", cf=2.0)
    x = _x(16, (16, D))
    py, _, _ = _check(jl, pl, x, aux=False)
    leaves = dict(pl.named_parameters())
    i = 5
    want = (torch.from_numpy(x[i]) @ leaves["stacked.weight"][i % E]
            + leaves["stacked.bias"][i % E])
    np.testing.assert_allclose(_np(py[i]), _np(want), rtol=1e-5, atol=1e-6)


def test_dense_route_of_an_index_gate_matches_index_form():
    """``BaseGate.route`` derived from ``route_indices``: the dense route
    of a gshard gate (a subclass that hides ``route_indices`` from the
    layer) gives the index form's output."""
    jl, pl = _pair(cf=1.0)

    class HiddenIndex(pt_moe.GShardGate):
        def route_indices(self, scores, capacity, valid=None):
            raise NotImplementedError

        def route(self, scores, capacity):
            # BaseGate.route over the gshard index routing
            self.route_indices = lambda s, c, valid=None: \
                pt_moe.GShardGate.route_indices(self, s, c, valid)
            try:
                return pt_moe.BaseGate.route(self, scores, capacity)
            finally:
                del self.route_indices
    x = torch.from_numpy(_x(17))
    with flag_values(pt_values=OFF), torch.no_grad():
        index = pl(x)
        hidden = HiddenIndex(D, E, device="cpu")
        hidden.weight.copy_(pl.gate.weight)
        pl.gate = hidden
        dense = pl(x)
    np.testing.assert_allclose(_np(dense), _np(index), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- recompute
@pytest.mark.parametrize("expert,mode", [("swiglu", "on"), ("swiglu", "off"),
                                         ("linear", "off")])
def test_recompute_interval_is_bitwise_and_matches_jax(expert, mode):
    """``recompute_interval=1`` in the grouped arm (the expert MLP under a
    checkpoint) and the index form (the vmapped experts under one): the
    port's output and every gradient bit for bit those of
    ``recompute_interval=0``, and JAX's ``recompute_interval=1`` (its
    ``jax.checkpoint``) at the fp32 tier."""
    _, plain = _pair(expert=expert, cf=1.0)
    jl, pl = _pair(expert=expert, cf=1.0, recompute=1)
    assert pl._recompute and not plain._recompute
    x = _x(18)
    with flag_values({"moe_grouped_gemm": mode},
                     {"moe_grouped_gemm": mode}):
        py, pdx, pg = _check(jl, pl, x, mode=mode)
        qy, _, qdx, qg = _pt_run(plain, x)
    assert torch.equal(py, qy) and torch.equal(pdx, qdx)
    for n in pg:
        assert torch.equal(pg[n], qg[n]), n


# ------------------------------------------------------------------ dtypes
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_experts_match_jax(dtype):
    """fp16 and bf16 SwiGLU experts against JAX's index form in the same
    dtype, at the bf16 tier. Under the default flags bf16 takes the
    grouped path; fp16, which the kernels do not take, takes the index
    form with one warning naming the dtype."""
    jl, pl = _pair(cf=1.0, dtype=dtype)
    moe_layer._warned_fallbacks.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _check(jl, pl, _x(19), dtype=dtype, tol=BF16)
        _pt_run(pl, _x(19), dtype)
    msgs = [str(w.message) for w in caught
            if "moe_grouped_gemm" in str(w.message)]
    if dtype == "float16":
        assert len(msgs) == 1 and "torch.float16" in msgs[0], msgs
    else:
        assert not msgs, msgs
    with flag_values(pt_values=OFF):
        _check(jl, pl, _x(20), dtype=dtype, tol=BF16)


def test_fp16_route_is_chosen_before_any_launch():
    """The route follows ``grouped_gemm.eligible``, a function of dtype and
    shape: fp16 is refused, fp32 and bf16 taken, empty shapes refused."""
    assert pgg.eligible(4, 8, 16, 32, torch.float32)
    assert pgg.eligible(4, 8, 16, 32, torch.bfloat16)
    assert not pgg.eligible(4, 8, 16, 32, torch.float16)
    assert not pgg.eligible(4, 0, 16, 32, torch.float32)


# ------------------------------------------------------- the MoE Llama
def test_moe_llama_off_loss_grads_and_steps_match_jax():
    """The fp32 tiny MoE Llama (``bench.py:131-136``) with both sides at
    ``moe_grouped_gemm=off``: the loss and every parameter's gradient,
    with no kernel launched; then three AdamW steps (losses at rtol 1e-5,
    every parameter within 1e-4 and 99.9% of elements at rtol 1e-5 /
    atol 1e-6, the tolerance of ``tests/test_torch_moe.py``)."""
    jm, pm = _models(seed=41)
    ids = np.random.RandomState(6).randint(0, 512, size=(2, 16)) \
        .astype("int32")
    with flag_values(OFF, OFF):
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
        jloss.backward()
        kernels.reset_launch_counts()
        ploss, _ = pm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
        ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    jp = dict(jm.named_parameters())
    _grads_close([(n, p.grad, jp[n].grad) for n, p in pm.named_parameters()])
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}

    jm, pm = _models(seed=41)
    with flag_values(OFF, OFF):
        jl, pl = _train(jm, pm, ids, 3)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pl[2] < pl[0]
    jstate = jm.state_dict()
    within = total = 0
    for name, p in pm.named_parameters():
        a, b = _np(p), _np(jstate[name])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
        within += int(np.isclose(a, b, rtol=1e-5, atol=1e-6).sum())
        total += a.size
    assert within >= 0.999 * total, (within, total)


def _prompts(seed=8):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 512, size=n).tolist() for n in (5, 9, 3)]


def test_compiled_engine_off_matches_jax():
    """The compiled engines with ``moe_grouped_gemm=off`` on both sides:
    the decode step's per-expert einsum arm over the expert-major buffer
    at ``c_pad = capacity``, with the pad rows masked out of routing;
    greedy tokens equal JAX's token for token, every page free after, no
    grouped GEMM run."""
    jm, pm = _models(seed=43)
    jm.eval()
    pm.eval()
    prompts = _prompts()
    before = (pgg.launches, pgg.launches_gmm2)
    with flag_values(OFF, OFF):
        ref = JaxEngine(jm, mode="compiled", max_seqs=4, max_seq_len=64,
                        block_size=16).generate(
            [JaxRequest(i, p, max_new_tokens=6)
             for i, p in enumerate(prompts)])
        eng = GenerationEngine(pm, mode="compiled", max_seqs=4,
                               max_seq_len=64, block_size=16)
        out = eng.generate([GenerationRequest(i, p, max_new_tokens=6)
                            for i, p in enumerate(prompts)])
    assert out == ref
    assert eng.cache.free_blocks == eng.cache.num_blocks
    assert (pgg.launches, pgg.launches_gmm2) == before


def test_dense_gate_moe_llama_serves_eager_like_jax():
    """A tiny MoE Llama whose gates give only the dense ``route``: in
    ``mode="auto"`` both engines fall back to the eager layer walk with one
    warning naming the gate, and the port's greedy tokens (through
    ``MoELayer.forward``'s dense route) equal JAX's eager engine's token
    for token. ``mode="compiled"`` refuses it."""
    jm, pm = _models(seed=44)
    for jlayer, player in zip(jm.llama.layers, pm.llama.layers):
        jg = JaxDenseTop1Gate(128, 4)
        jg.weight.set_value(jlayer.mlp.gate.weight)
        jlayer.mlp.gate = jg
        pg = PtDenseTop1Gate(128, 4, device="cpu")
        with torch.no_grad():
            pg.weight.copy_(player.mlp.gate.weight)
        player.mlp.gate = pg
    jm.eval()
    pm.eval()
    prompts = _prompts(9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JaxEngine(jm, mode="auto", max_seqs=4, max_seq_len=64,
                        block_size=16).generate(
            [JaxRequest(i, p, max_new_tokens=6)
             for i, p in enumerate(prompts)])
    pt_engine._warned_fallbacks.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = GenerationEngine(pm, mode="auto", max_seqs=4, max_seq_len=64,
                               block_size=16)
        GenerationEngine(pm, mode="auto", max_seqs=4, max_seq_len=64,
                         block_size=16)
    msgs = [str(w.message) for w in caught
            if "compiled decode" in str(w.message)]
    assert len(msgs) == 1 and "PtDenseTop1Gate" in msgs[0], msgs
    assert eng.mode == "eager"
    out = eng.generate([GenerationRequest(i, p, max_new_tokens=6)
                        for i, p in enumerate(prompts)])
    assert out == ref
    assert eng.cache.free_blocks == eng.cache.num_blocks
    with pytest.raises(NotImplementedError, match="route_indices"):
        GenerationEngine(pm, mode="compiled", max_seqs=4, max_seq_len=64,
                         block_size=16)


# --------------------------------------------------------- load_jax_state
@pytest.mark.parametrize("expert", ["linear", "gelu-mlp"])
def test_load_jax_state_carries_bias_stacks(expert):
    """Every stacked leaf of a bias-expert layer, and the gate weight,
    crosses under the JAX name bitwise; the template stays out of the
    port's parameters and state dict."""
    jl, pl = _pair(expert=expert)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    got = pl.state_dict()
    assert set(got) == set(state) == {n for n, _ in pl.named_parameters()}
    assert any(k.endswith("bias") for k in state)
    for k, v in state.items():
        assert torch.equal(got[k], to_torch(v)), k
    assert all(p.device.type == "meta"
               for p in pl.__dict__["_template"].parameters())


# ------------------------------------------------------------ the flags
def test_flag_rules():
    """``moe_grouped_gemm``: ``auto`` and ``on`` (any case) take the
    grouped path, ``off`` the index form, anything else raises;
    ``moe_a2a_dispatch``: ``on`` forces the a2a path, ``off`` turns it
    off, ``auto`` follows ``moe_grouped_gemm``."""
    saved = {k: pt_flags.flag(k) for k in ("moe_grouped_gemm",
                                          "moe_a2a_dispatch")}
    try:
        for value, want in (("auto", True), ("on", True), ("ON", True),
                            ("off", False), ("Off", False)):
            pt_flags.set_flags({"moe_grouped_gemm": value})
            assert pgg.fast_path_enabled() is want, value
        pt_flags.set_flags({"moe_grouped_gemm": "sometimes"})
        with pytest.raises(ValueError, match="moe_grouped_gemm"):
            pgg.fast_path_enabled()
        for grouped in ("auto", "on", "off"):
            pt_flags.set_flags({"moe_grouped_gemm": grouped})
            for dispatch, want in (("on", True), ("off", False),
                                   ("auto", grouped != "off")):
                pt_flags.set_flags({"moe_a2a_dispatch": dispatch})
                assert moe_a2a.a2a_enabled() is want, (grouped, dispatch)
    finally:
        pt_flags.set_flags(saved)
