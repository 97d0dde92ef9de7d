"""The port's MoE path (gates, ``MoELayer``, the MoE Llama trained and
served) against the JAX package.

Scores, tokens and prompts are made with numpy; weights are made by the
JAX side from a seed and carried across with ``load_jax_state``. On the
CPU the port's grouped GEMMs run their plain twins; the JAX side runs its
grouped path (``moe_grouped_gemm=on``, Pallas in interpret mode) or its
index-form path (``off``), which agree with each other to float tolerance.
Tolerances follow ``tests/op_harness.py`` (fp32 rtol 1e-5 / atol 1e-6)
unless a test states its own.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jax_flags
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.incubate.distributed.models import moe as jax_moe
from paddle_tpu.inference import GenerationEngine as JaxEngine
from paddle_tpu.inference import GenerationRequest as JaxRequest
from paddle_tpu.models import llama as jax_llama
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch import jit as pt_jit
from paddle_tpu_torch import nn as pt_nn
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch.incubate.distributed.models import moe as pt_moe
from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.weights import load_jax_state

# bench.py:131-136, the MoE bench's CPU configuration
MOE_TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=8, max_position_embeddings=256,
                moe_num_experts=4, moe_capacity_factor=2.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    data = getattr(x, "_data", x)
    return np.asarray(np.asarray(data, np.float32), np.float64)


@contextlib.contextmanager
def flag_values(jax_values=None, pt_values=None):
    """Flags set on each side for the block, restored after."""
    saved = []
    for mod, values in ((jax_flags, jax_values), (pt_flags, pt_values)):
        for name, value in (values or {}).items():
            saved.append((mod, name, mod.flag(name)))
            mod.set_flags({name: value})
    try:
        yield
    finally:
        for mod, name, value in saved:
            mod.set_flags({name: value})


def _grads_close(pairs, rtol=1e-5, atol=1e-6):
    """``(name, port, jax)`` triples; atol scaled by each gradient's
    largest magnitude, since each element is a sum of products."""
    for name, got, want in pairs:
        w = _np(want)
        np.testing.assert_allclose(_np(got), w, rtol=rtol,
                                   atol=atol * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


# ------------------------------------------------------------------ gates
_GATES = [("naive", jax_moe.NaiveGate, pt_moe.NaiveGate),
          ("switch", jax_moe.SwitchGate, pt_moe.SwitchGate),
          ("gshard", jax_moe.GShardGate, pt_moe.GShardGate)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,jgate,pgate", _GATES)
def test_gate_routing_matches_jax(name, jgate, pgate, masked):
    """``route_indices`` on the same fp32 scores, at a capacity that drops
    tokens, with and without a ``valid`` mask: expert, slot and keep equal
    exactly (row 0 holds a tie, which both resolve to the first maximum),
    weights and the aux loss to 1e-6."""
    rs = np.random.RandomState(10)
    n, e, cap = 24, 4, 5
    scores = rs.randn(n, e).astype(np.float32)
    scores[0, 1] = scores[0, 3] = scores[0].max() + 1.0
    valid = rs.rand(n) > 0.3 if masked else None
    jg = jgate(8, e)
    pg = pgate(8, e, device="cpu")
    jout = jg.route_indices(paddle.to_tensor(scores)._data, cap,
                            valid=None if valid is None
                            else paddle.to_tensor(valid)._data)
    pout = pg.route_indices(torch.from_numpy(scores), cap,
                            valid=None if valid is None
                            else torch.from_numpy(valid))
    names = ("e_idx", "slot", "w", "keep", "aux")
    for what, p, j in zip(names, pout, jout):
        if what in ("w", "aux"):
            np.testing.assert_allclose(_np(p), _np(j), rtol=1e-6, atol=1e-6,
                                       err_msg=what)
        else:
            assert np.array_equal(p.numpy(), np.asarray(j)), what
    keep = pout[3].numpy()
    assert not keep.all()                       # the capacity dropped some
    if masked:
        assert not keep[~valid].any()
    assert pout[0].dtype == pout[1].dtype == torch.int32
    assert pg.capacity(n, 2.0, 2) == jg.capacity(n, 2.0, 2)


def test_dense_route_matches_jax():
    """``route`` (derived from the index routing) gives JAX's combine."""
    scores = np.random.RandomState(11).randn(10, 4).astype(np.float32)
    jc, jd, _ = jax_moe.GShardGate(8, 4).route(
        paddle.to_tensor(scores)._data, 3)
    pc, pd, _ = pt_moe.GShardGate(8, 4, device="cpu").route(
        torch.from_numpy(scores), 3)
    np.testing.assert_allclose(_np(pc), _np(jc), rtol=1e-6, atol=1e-6)
    assert np.array_equal(pd.numpy(), np.asarray(jd))


# --------------------------------------------------------------- MoELayer
def _layer_pair(gate, cf, seed=12):
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaMLP as JaxMLP
    paddle.seed(seed)
    jcfg = JaxConfig(hidden_size=16, intermediate_size=32)
    jl = jax_moe.MoELayer(16, [JaxMLP(jcfg) for _ in range(4)], gate=gate,
                          capacity_factor=cf)
    pcfg = LlamaConfig(hidden_size=16, intermediate_size=32)
    init = pt_llama._Init(pcfg, torch.device("cpu"), torch.Generator())
    pl = pt_moe.MoELayer(16, [pt_llama.LlamaMLP(pcfg, init)
                              for _ in range(4)], gate=gate,
                         capacity_factor=cf)
    load_jax_state(pl, {k: np.asarray(v.numpy())
                        for k, v in jl.state_dict().items()})
    return jl, pl


@pytest.mark.parametrize("jax_mode", ["on", "off"])
@pytest.mark.parametrize("gate,cf", [("gshard", 1.0), ("switch", 1.25),
                                     ("naive", 2.0)])
def test_moe_layer_matches_jax(gate, cf, jax_mode):
    """Output, aux loss and the gradients of the tokens, the gate weight
    and the three stacked expert leaves of ``(y*y).sum() + aux`` against
    JAX's grouped path (``on``) and its index-form path (``off``). cf 1.0
    at top-2 overflows the capacity, so the drops must match too."""
    jl, pl = _layer_pair(gate, cf)
    x = np.random.RandomState(13).randn(2, 16, 16).astype(np.float32)
    with flag_values({"moe_grouped_gemm": jax_mode}):
        jx = paddle.to_tensor(x, stop_gradient=False)
        jy = jl(jx)
        jloss = (jy * jy).sum() + jl.gate.get_loss()
        jloss.backward()
    px = torch.from_numpy(x).requires_grad_(True)
    py = pl(px)
    ploss = (py * py).sum() + pl.gate.get_loss()
    ploss.backward()
    np.testing.assert_allclose(_np(py), _np(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    jp = dict(jl.named_parameters())
    _grads_close([("x", px.grad, jx.grad)]
                 + [(n, p.grad, jp[n].grad) for n, p in pl.named_parameters()])
    assert {n for n, _ in pl.named_parameters()} == set(jp)


def test_moe_layer_refuses_what_is_not_ported():
    """Mesh axes beside ``ep`` and the reference's communicator groups
    (A.10) raise; ``recompute_interval``, experts other than SwiGLU MLPs,
    a gate with only the dense route and ``moe_grouped_gemm=off`` are
    ported and run."""
    from paddle_tpu_torch import distributed as pt_dist
    pcfg = LlamaConfig(hidden_size=16, intermediate_size=32)
    init = pt_llama._Init(pcfg, torch.device("cpu"), torch.Generator())
    experts = [pt_llama.LlamaMLP(pcfg, init) for _ in range(2)]
    # expert parallelism is ported over an ["ep"] mesh; data and tensor
    # axes beside it, and the reference's communicator groups, are not
    dp_ep = pt_dist.ProcessMesh([[0, 1], [2, 3]], ["dp", "ep"])
    ep_mp = pt_dist.ProcessMesh([[0, 1], [2, 3]], ["ep", "mp"])
    for kw in (dict(mesh=dp_ep), dict(mesh=ep_mp), dict(moe_group=object()),
               dict(mp_group=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
            pt_moe.MoELayer(16, experts, **kw)
    layer = pt_moe.MoELayer(16, experts)
    for mesh in (dp_ep, ep_mp):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
            layer.shard_experts(mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
        pt_llama.llama_shard_fn(dp_ep)
    x = torch.randn(4, 16)
    assert pt_moe.MoELayer(16, experts, recompute_interval=1)(x).shape \
        == x.shape
    assert pt_moe.MoELayer(16, [pt_nn.Linear(16, 16, bias=True)
                                for _ in range(2)])(x).shape == x.shape
    # BaseGate.route derived from route_indices: a gate with neither
    # still names what it lacks
    with pytest.raises(NotImplementedError):
        pt_moe.MoELayer(16, experts,
                        gate=pt_moe.BaseGate(16, 2, device="cpu"))(x)
    with flag_values(pt_values={"moe_grouped_gemm": "off"}):
        assert layer(x).shape == x.shape


# ------------------------------------------------------- the MoE Llama
def _models(dtype="float32", seed=31):
    paddle.seed(seed)
    jcfg = jax_llama.LlamaConfig(dtype=dtype, **MOE_TINY)
    jm = jax_llama.LlamaForCausalLM(jcfg)
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    pcfg = LlamaConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)
                          if f.name in names})
    pm = LlamaForCausalLM(pcfg, device="cpu")
    load_jax_state(pm, {k: np.asarray(v.numpy())
                        for k, v in jm.state_dict().items()})
    return jm, pm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_jax_state_carries_the_moe_leaves(dtype):
    """The gate weight and the stacked expert leaves cross under the JAX
    names, in the model dtype (norms fp32), bitwise."""
    jm, pm = _models(dtype, seed=32)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    params = dict(pm.named_parameters())
    assert set(params) == set(state)
    for name in ("llama.layers.1.mlp.gate.weight",
                 "llama.layers.1.mlp.stacked.gate_proj__weight",
                 "llama.layers.1.mlp.stacked.up_proj__weight",
                 "llama.layers.1.mlp.stacked.down_proj__weight"):
        p = params[name]
        assert str(p.dtype) == f"torch.{dtype}", name
        raw = state[name]
        back = p.detach().view(torch.int16 if p.dtype == torch.bfloat16
                               else p.dtype).numpy()
        assert np.array_equal(back, raw.view(np.int16)
                              if raw.dtype.name == "bfloat16" else raw)
    assert params["llama.layers.0.mlp.stacked.down_proj__weight"].shape \
        == (4, 128, 128)
    assert params["llama.layers.0.mlp.gate.weight"].shape == (128, 4)


@pytest.mark.parametrize("jax_mode", ["on", "off"])
def test_moe_llama_loss_and_grads_match_jax(jax_mode):
    """The loss (LM loss plus 0.01 x each layer's aux) and every
    parameter's gradient of the fp32 tiny MoE Llama, against JAX's grouped
    (``on``) and index-form (``off``) MoE paths."""
    jm, pm = _models(seed=33)
    ids = np.random.RandomState(6).randint(0, 512, size=(2, 16)) \
        .astype("int32")
    with flag_values({"moe_grouped_gemm": jax_mode}):
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
        jloss.backward()
    kernels.reset_launch_counts()
    ploss, _ = pm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    aux = sum(float(l.mlp.gate.get_loss()) for l in pm.llama.layers)
    assert aux > 0
    jp = dict(jm.named_parameters())
    _grads_close([(n, p.grad, jp[n].grad) for n, p in pm.named_parameters()])
    assert kernels.launch_counts() == {n: 0 for n in kernels.KERNELS}


def _train(jm, pm, ids, steps, lr=1e-3):
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


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_moe_llama_three_adamw_steps_match_jax(fused):
    """Three AdamW steps (lr 1e-3, wd 0.1) of the fp32 tiny MoE Llama at
    the tolerance ``tests/test_torch_llama_train.py`` states for Adam:
    losses at rtol 1e-5; 99.9% of parameter elements at rtol 1e-5 / atol
    1e-6 and every element within 1e-4. MoE layers compose whatever
    ``pallas_fused_block`` says (the fused block refuses them on both
    sides)."""
    jm, pm = _models(seed=34)
    ids = np.random.RandomState(7).randint(0, 512, size=(2, 16)) \
        .astype("int32")
    with flag_values({"pallas_fused_block": fused},
                     {"pallas_fused_block": fused}):
        jl, pl = _train(jm, pm, ids, 3)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert pl[2] < pl[0]
    jstate = jm.state_dict()
    within = total = 0
    for name, p in pm.named_parameters():
        assert p.grad is None, name
        a, b = _np(p), _np(jstate[name])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
        within += int(np.isclose(a, b, rtol=1e-5, atol=1e-6).sum())
        total += a.size
    assert within >= 0.999 * total, (within, total)


# ----------------------------------------------------------- serving
def test_moe_engine_greedy_matches_jax_compiled_engine():
    """Greedy tokens of the fp32 tiny MoE Llama through the port's engine
    against the JAX engine in compiled mode, token for token. Three
    prompts of 17 tokens in all fill a 32-token bucket and the decode steps
    an 8-token one, so pad rows are masked out of routing (``valid``)."""
    jm, pm = _models(seed=35)
    jm.eval()
    pm.eval()
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 512, size=n).tolist() for n in (5, 9, 3)]
    jeng = JaxEngine(jm, mode="compiled", max_seqs=4, max_seq_len=64,
                     block_size=16)
    ref = jeng.generate([JaxRequest(i, p, max_new_tokens=6)
                         for i, p in enumerate(prompts)])
    eng = GenerationEngine(pm, max_seqs=4, max_seq_len=64, block_size=16)
    out = eng.generate([GenerationRequest(i, p, max_new_tokens=6)
                        for i, p in enumerate(prompts)])
    assert out == ref
    assert eng.cache.free_blocks == eng.cache.num_blocks


def test_moe_step_pads_take_no_capacity():
    """The decode step's MoE MLP routes with the pad rows masked: 4 real
    tokens behind 60 pad rows (copies of token 0, so unmasked they would
    fill its experts first) give the output the 4 tokens give alone, at
    the same capacity (2: cf 1.0 for 4 tokens, 1/16 for 64)."""
    from paddle_tpu_torch.inference import decode_step as pt_ds
    _, pm = _models(seed=36)
    lp = pt_ds.extract_params(pm)["layers"][0]
    spec = pt_ds.extract_moe_specs(pm)[0]
    x = torch.from_numpy(np.random.RandomState(9).randn(4, 128)
                         .astype(np.float32))
    xp = torch.cat([x[:1].repeat(60, 1), x])
    with torch.no_grad():
        alone = pt_ds._moe_mlp(x, lp, dict(spec, cf=1.0), True,
                               torch.ones(4, dtype=torch.bool))
        padded = pt_ds._moe_mlp(xp, lp, dict(spec, cf=1 / 16), True,
                                torch.arange(64) >= 60)
        unmasked = pt_ds._moe_mlp(xp, lp, dict(spec, cf=1 / 16), True,
                                  torch.ones(64, dtype=torch.bool))
    np.testing.assert_allclose(_np(padded[60:]), _np(alone), rtol=1e-5,
                               atol=1e-6)
    assert not torch.allclose(unmasked[60:], alone)
