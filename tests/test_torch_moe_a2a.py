"""The port's expert-parallel MoE dispatch against the JAX package.

The port runs in four spawned CPU ranks over a gloo group
(``tests/_torch_ep_ranks.py``; spawned once for the module): ``["ep"]``
meshes of two ranks (ranks 0 and 1) and of four. Every rank holds the same
global inputs and runs its own rows. The JAX reference runs in this process
on the 8-device CPU mesh of ``tests/conftest.py`` at the same ep, on the
same numpy inputs: ``ragged_all_to_all`` and ``lax.all_to_all`` under
``shard_map``, the composed ``_fused_exchange_mlp`` (its Pallas kernel is
TPU-only) and the a2a ``MoELayer`` with its grouped GEMMs in Pallas
interpret mode (``moe_grouped_gemm=on``). Tolerances follow
``tests/op_harness.py`` (fp32 rtol 1e-5 / atol 1e-6, the gradients' atol
scaled by their largest magnitude); exchanges and gathers are held bit for
bit, and the port's expert-parallel layer against its own one-device layer
bit for bit in y and dx (the reference's contract,
``tests/test_moe_a2a.py:273-320``). The all-gather expert path over
sharded experts (the a2a path off; the index form and the grouped form)
is held against JAX's GSPMD path on the same mesh and bit for bit against
the port's one-device layer under the same flags.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import flags as jax_flags
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.incubate.distributed.models.moe import moe_a2a as jax_a2a
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.ops.pallas.autotune import resolve_gmm_blocks

import _torch_ep_ranks
import paddle_tpu_torch.distributed as pdist
from paddle_tpu_torch.incubate.distributed.models.moe import moe_a2a
from paddle_tpu_torch.models import LlamaConfig

_smap = getattr(jax, "shard_map", None)
if _smap is None:               # older jax
    from jax.experimental.shard_map import shard_map as _smap

MESHES = {"ep2": ([0, 1], ["ep"]), "ep4": ([0, 1, 2, 3], ["ep"])}
EP = {"ep2": 2, "ep4": 4}
FP32 = dict(rtol=1e-5, atol=1e-6)


def _shard_map(body, w, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:w]), ("ep",))
    try:
        return _smap(body, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)
    except TypeError:           # older jax spells it check_rep
        return _smap(body, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_rep=False)


def _close(got, want, err_msg=""):
    """fp32 tier, atol scaled by the reference's largest magnitude."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=FP32["rtol"], err_msg=err_msg,
                               atol=FP32["atol"] * max(np.abs(want).max(), 1))


# -------------------------------------------------------------- the cases
def _ragged_cases():
    """``tests/test_moe_a2a.py:72-200``: round trips with drops (dest -1),
    bucket overflow (every row to rank 0, bucket 2), meta riding along."""
    cases = []
    for mesh in MESHES:
        w = EP[mesh]
        for label, dtype, dest, bucket in (
                ("round-trip", "float32", "drop", 8),
                ("round-trip-bf16", "bfloat16", "drop", 8),
                ("overflow", "float32", "zero", 2),
                ("meta", "float32", "all", 8)):
            rs = np.random.RandomState(len(cases))
            n = 8 * w
            d = {"drop": rs.randint(-1, w, n), "zero": np.zeros(n),
                 "all": rs.randint(0, w, n)}[dest].astype(np.int32)
            cases.append(dict(
                id=f"{mesh}-{label}", mesh=mesh, kind="ragged",
                dtype=dtype, bucket=bucket, dest=d,
                x=rs.randn(n, 4).astype(np.float32),
                meta=(np.arange(n) % 7).astype(np.int32)))
    return cases


def _tiled_cases():
    cases = []
    for mesh in MESHES:
        w = EP[mesh]
        rs = np.random.RandomState(50 + len(cases))
        for dtype, x in (("float32", rs.randn(w * w * 3, 5)),
                         ("int32", rs.randint(-9, 9, (w * w * 4,))),
                         ("bfloat16", rs.randn(w * w * 2, 3, 2))):
            x = x.astype(np.int32 if dtype == "int32" else np.float32)
            cases.append(dict(id=f"{mesh}-tiled-{dtype}", mesh=mesh,
                              kind="tiled", dtype=dtype, x=x))
    return cases


def _fused_cases(dtype="float32"):
    """#17's twin: per rank a packed send buffer, an ``inv`` that lands
    each expert's first ``counts`` slots on distinct rows of the chunk's
    landing buffer (sentinel ``w*bucket`` elsewhere), local expert 1 of
    rank 0 empty; the raw ``y`` buffer compared at the same ``c_pad``."""
    cases = []
    m, ffn, e_local, capacity = 16, 32, 2, 12
    tag = "" if dtype == "float32" else f"-{dtype}"
    for mesh in MESHES:
        w = EP[mesh]
        block_m, block_n = resolve_gmm_blocks(e_local, capacity, m, ffn,
                                              getattr(jnp, dtype))
        c_pad = -(-capacity // block_m) * block_m
        for chunks in (1, 2):
            rs = np.random.RandomState(90 + len(cases))
            bucket = 6
            wb = w * bucket
            counts = rs.randint(1, capacity + 1, (w, chunks * e_local))
            counts[0, 1] = 0
            inv = np.full((w, chunks * e_local * c_pad), wb, np.int32)
            for r in range(w):
                for c in range(chunks):
                    rows = rs.permutation(wb)
                    at = 0
                    for e in range(e_local):
                        k = min(counts[r, c * e_local + e], wb - at)
                        counts[r, c * e_local + e] = k
                        base = (c * e_local + e) * c_pad
                        inv[r, base:base + k] = rows[at:at + k]
                        at += k
            cases.append(dict(
                id=f"{mesh}-fused{tag}-chunks{chunks}", mesh=mesh,
                kind="fused", dtype=dtype,
                chunks=chunks, bucket=bucket, c_pad=c_pad, block_m=block_m,
                block_n=block_n,
                x_send=rs.randn(w * chunks * wb, m).astype(np.float32),
                counts=counts.reshape(-1).astype(np.int32),
                inv=inv.reshape(-1),
                g=(rs.randn(w * e_local, m, ffn) * 0.3).astype(np.float32),
                u=(rs.randn(w * e_local, m, ffn) * 0.3).astype(np.float32),
                d=(rs.randn(w * e_local, ffn, m) * 0.3).astype(np.float32),
                cot=rs.randn(w * chunks * e_local * c_pad, m)
                .astype(np.float32)))
    return cases


FUSED_ON = dict(moe_a2a_fused_kernel="auto")
COMPOSED = dict(moe_a2a_fused_kernel="off")
OVERLAP = dict(moe_a2a_overlap=True, moe_a2a_chunks=2)
# every value of the five a2a flags: "on" is an alias of "auto" for each,
# pallas_async_a2a=off takes the collective exchange on these CPU ranks,
# moe_a2a_dispatch=off the one-device path over all E experts
ALIASES = dict(moe_a2a_dispatch="on", pallas_async_a2a="on",
               moe_a2a_fused_kernel="on")
COLLECTIVE = dict(pallas_async_a2a="off")
# id -> (mesh, experts, capacity factor, x shape, JAX overlap, port flags)
LAYERS = {
    "ep2": ("ep2", 8, 2.0, (4, 32, 16), False,
            {"fused": FUSED_ON, "composed": COMPOSED,
             "full-experts": FUSED_ON, "on": ALIASES,
             "composed-collective": dict(COMPOSED, **COLLECTIVE),
             "full-dispatch-off": dict(moe_a2a_dispatch="off")}),
    "ep4-overlap": ("ep4", 8, 2.0, (4, 32, 16), True,
                    {"fused": dict(FUSED_ON, **OVERLAP),
                     "composed": dict(COMPOSED, **OVERLAP),
                     "fused-collective-chunks4": dict(
                         FUSED_ON, moe_a2a_overlap=True, moe_a2a_chunks=4,
                         **COLLECTIVE)}),
    "ep2-drops": ("ep2", 8, 1.0, (4, 32, 16), False,
                  {"fused": FUSED_ON, "composed-overlap":
                   dict(COMPOSED, **OVERLAP)}),
    "ep4-empty-experts": ("ep4", 16, 2.0, (4, 8, 16), False,
                          {"fused": FUSED_ON, "composed": COMPOSED}),
}


def _jax_layer(experts, cf):
    from paddle_tpu.incubate.distributed.models.moe.moe_layer import (
        MoELayer)
    paddle.seed(0)
    cfg = jax_llama.LlamaConfig(hidden_size=16, intermediate_size=32)
    return MoELayer(16, [jax_llama.LlamaMLP(cfg) for _ in range(experts)],
                    gate="gshard", capacity_factor=cf)


def _layer_cases():
    cases = []
    for lid, (mesh, experts, cf, shape, _, port_flags) in LAYERS.items():
        layer = _jax_layer(experts, cf)
        cases.append(dict(
            id=f"layer-{lid}", mesh=mesh, kind="layer", hidden=16, ffn=32,
            experts=experts, cf=cf, flags=port_flags,
            weights={k: np.asarray(v.numpy())
                     for k, v in layer.state_dict().items()},
            x=np.random.RandomState(7).randn(*shape).astype(np.float32)))
    return cases


# the all-gather expert path over sharded experts (the a2a path off): id
# -> (mesh, experts, capacity factor, expert kind, recompute, flags, the
# same on both sides). moe_grouped_gemm=off with moe_a2a_dispatch=auto
# is the index form (auto follows the grouped-GEMM flag); on with
# moe_a2a_dispatch=off the grouped form
INDEX = dict(moe_grouped_gemm="off", moe_a2a_dispatch="auto")
GROUPED = dict(moe_grouped_gemm="on", moe_a2a_dispatch="off")
GATHER = {
    "ep2-index": ("ep2", 8, 2.0, "mlp", 0, INDEX),
    "ep4-index-drops": ("ep4", 8, 1.0, "mlp", 0, INDEX),
    "ep2-grouped": ("ep2", 8, 2.0, "mlp", 0, GROUPED),
    "ep4-grouped-drops": ("ep4", 8, 1.0, "mlp", 0, GROUPED),
    "ep2-linear": ("ep2", 8, 2.0, "linear", 0, INDEX),
    "ep4-index-recompute": ("ep4", 8, 2.0, "mlp", 1, INDEX),
    "ep2-grouped-recompute": ("ep2", 8, 1.0, "mlp", 1, GROUPED),
}


def _jax_gather_layer(gid):
    """The JAX layer of an all-gather case, its stacked biases random."""
    from paddle_tpu.incubate.distributed.models.moe.moe_layer import (
        MoELayer)
    _, experts, cf, kind, remat, _ = GATHER[gid]
    paddle.seed(0)
    if kind == "linear":
        made = [paddle.nn.Linear(16, 16) for _ in range(experts)]
    else:
        cfg = jax_llama.LlamaConfig(hidden_size=16, intermediate_size=32)
        made = [jax_llama.LlamaMLP(cfg) for _ in range(experts)]
    layer = MoELayer(16, made, gate="gshard", capacity_factor=cf,
                     recompute_interval=remat)
    rs = np.random.RandomState(3)
    layer.set_state_dict({
        k: (rs.randn(*v.shape) * 0.5).astype(np.float32)
        if k.endswith("bias") else np.asarray(v.numpy())
        for k, v in layer.state_dict().items()})
    return layer


def _gather_cases():
    cases = []
    for gid, (mesh, experts, cf, kind, remat, flag_set) in GATHER.items():
        layer = _jax_gather_layer(gid)
        cases.append(dict(
            id=f"gather-{gid}", mesh=mesh, kind="gather", hidden=16, ffn=32,
            experts=experts, cf=cf, expert=kind, recompute=remat,
            flags=flag_set,
            weights={k: np.asarray(v.numpy())
                     for k, v in layer.state_dict().items()},
            x=np.random.RandomState(8).randn(4, 32, 16).astype(np.float32)))
    return cases


def _llama_spec():
    paddle.seed(0)
    jcfg = jax_llama.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, moe_num_experts=4,
        moe_capacity_factor=2.0)
    jm = jax_llama.LlamaForCausalLM(jcfg)
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    config = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name in names}
    ids = np.random.RandomState(2).randint(0, 128, size=(2, 16)) \
        .astype(np.int32)
    weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, dict(id="llama", mesh="ep2", kind="llama", config=config,
                    weights=weights, ids=ids)


RAGGED, TILED, FUSED = _ragged_cases(), _tiled_cases(), _fused_cases()
FUSED_BF16 = _fused_cases("bfloat16")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: one spawn of four gloo ranks for the module."""
    work = tmp_path_factory.mktemp("ep_ranks")
    layers = _layer_cases()
    gathers = _gather_cases()
    jm, llama = _llama_spec()
    torch.save(dict(meshes=MESHES,
                    cases=RAGGED + TILED + FUSED + FUSED_BF16 + layers
                    + gathers + [llama]),
               work / "spec.pt")
    pdist.spawn(_torch_ep_ranks.run, (str(work),), nprocs=4, timeout=600)
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    return {c["id"]: c for c in layers + gathers}, jm, llama, got


@pytest.fixture(autouse=True)
def _restore_jax():
    yield
    jax_flags.set_flags({"moe_grouped_gemm": "auto",
                         "moe_a2a_dispatch": "auto",
                         "moe_a2a_overlap": False, "moe_a2a_chunks": 2})
    jdist.set_mesh(None)


def _per_rank(got, case):
    w = EP[case["mesh"]]
    return [got[r][case["id"]] for r in range(w)]


# --------------------------------------------------------------- the tests
@pytest.mark.parametrize("case", RAGGED, ids=[c["id"] for c in RAGGED])
def test_ragged_all_to_all_matches_jax(ranks, case):
    """The round trip (dispatch, return exchange, gather at ``send_pos``)
    bit for bit, the gradient mirror at the fp32 tier, ``recv_meta`` and
    ``send_pos`` exactly, against JAX's ``ragged_all_to_all``."""
    w = EP[case["mesh"]]
    dtype = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    x = jnp.asarray(case["x"], dtype)

    def body(x_, d_, m_):
        recv, recv_meta, send_pos = jcoll.ragged_all_to_all(
            x_, d_, bucket=case["bucket"], axis="ep", world=w, meta=m_)
        back = jcoll.ragged_all_to_all(recv, axis="ep", world=w)
        got = send_pos >= 0
        out = jnp.take(back, jnp.where(got, send_pos, 0), axis=0) \
            * got.astype(back.dtype)[:, None]
        return out, recv_meta, send_pos

    fn = _shard_map(body, w, (P("ep"),) * 3, (P("ep"),) * 3)
    dest, meta = jnp.asarray(case["dest"]), jnp.asarray(case["meta"])
    out, recv_meta, send_pos = jax.jit(fn)(x, dest, meta)
    grad = jax.jit(jax.grad(lambda x_: (fn(x_, dest, meta)[0].astype(
        jnp.float32) ** 2).sum() / 2))(x)
    got = _per_rank(ranks[3], case)
    for name, want in (("out", out), ("recv_meta", recv_meta),
                       ("send_pos", send_pos)):
        np.testing.assert_array_equal(
            np.concatenate([g[name] for g in got]),
            np.asarray(want, np.float32 if name == "out" else np.int32),
            err_msg=name)
    _close(np.concatenate([g["grad"] for g in got]),
           np.asarray(grad, np.float32), "grad")
    if case["id"].endswith("overflow"):
        kept = (np.arange(len(case["dest"])) % 8) < 2
        assert ((np.concatenate([g["send_pos"] for g in got]) >= 0)
                == kept).all()


@pytest.mark.parametrize("case", TILED, ids=[c["id"] for c in TILED])
def test_tiled_a2a_twin_matches_lax_all_to_all(ranks, case):
    """``tiled_a2a`` (its twin on CPU tensors), ``tiled_a2a_plain`` and
    the collective route against ``lax.all_to_all(tiled=True)``, bit for
    bit."""
    w = EP[case["mesh"]]
    dtype = {"float32": jnp.float32, "int32": jnp.int32,
             "bfloat16": jnp.bfloat16}[case["dtype"]]
    fn = _shard_map(lambda x_: jax.lax.all_to_all(
        x_, "ep", split_axis=0, concat_axis=0, tiled=True), w, (P("ep"),),
        P("ep"))
    want = np.asarray(jax.jit(fn)(jnp.asarray(case["x"], dtype)),
                      np.int32 if dtype == jnp.int32 else np.float32)
    for i in range(3):
        got = np.concatenate([g[i] for g in _per_rank(ranks[3], case)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", FUSED, ids=[c["id"] for c in FUSED])
def test_fused_exchange_mlp_twin_matches_jax(ranks, case):
    """#17's twin under the port's ``_FusedExchangeMlp`` against JAX's
    ``_fused_exchange_mlp`` (its composed reference off the TPU): ``y`` and
    the gradients of ``sum(y * cot)`` in ``x_send`` and the three expert
    stacks, at one and two chunks."""
    w = EP[case["mesh"]]
    jax_flags.set_flags({"moe_grouped_gemm": "on"})
    kw = dict(ep_axis="ep", ep=w, chunks=case["chunks"],
              bucket=case["bucket"], c_pad=case["c_pad"],
              block_m=case["block_m"], block_n=case["block_n"],
              ct=jnp.float32)
    fn = _shard_map(lambda xs, cn, iv, g, u, d: jax_a2a._fused_exchange_mlp(
        xs, cn, iv, g, u, d, **kw), w, (P("ep"),) * 6, P("ep"))
    args = [jnp.asarray(case[k]) for k in ("x_send", "counts", "inv", "g",
                                             "u", "d")]
    cot = jnp.asarray(case["cot"])
    y = jax.jit(fn)(*args)

    def loss(xs, g, u, d):
        return (fn(xs, args[1], args[2], g, u, d) * cot).sum()
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        args[0], *args[3:])
    got = _per_rank(ranks[3], case)
    for i, (name, want) in enumerate(zip(("y", "dx_send", "dg", "du", "dd"),
                                         (y,) + tuple(grads))):
        _close(np.concatenate([g[i] for g in got]), np.asarray(want), name)


def _kernel_numerics(xs, iv, g, u, d, *, w, chunks, bucket, c_pad):
    """The arithmetic of JAX's ``_fused_kernel``
    (``paddle_tpu/ops/pallas/async_collectives.py:464-476``), which has no
    interpreter off the TPU, per rank under ``shard_map``: the exchange and
    the ``inv`` gather as the composed path makes them, then gate and up
    kept in fp32, ``silu(g) * u`` rounded once to the compute dtype, and
    the down projection accumulated in fp32 and rounded on the store. Rows
    past a count gather zeros, so they come out zero as ``_emit`` writes
    them."""
    e_local, m = g.shape[0], g.shape[1]
    wb, rows = w * bucket, e_local * c_pad
    ys = []
    for c in range(chunks):
        recv = jax.lax.all_to_all(xs[c * wb:(c + 1) * wb], "ep",
                                  split_axis=0, concat_axis=0, tiled=True)
        ic = iv[c * rows:(c + 1) * rows]
        live = ic < wb
        xb = (jnp.take(recv, jnp.where(live, ic, 0), axis=0)
              * live.astype(recv.dtype)[:, None]).reshape(e_local, c_pad, m)
        hg = jnp.einsum("ecm,emf->ecf", xb, g,
                        preferred_element_type=jnp.float32)
        hu = jnp.einsum("ecm,emf->ecf", xb, u,
                        preferred_element_type=jnp.float32)
        act = (jax.nn.silu(hg) * hu).astype(xs.dtype)
        ys.append(jnp.einsum("ecf,efm->ecm", act, d,
                             preferred_element_type=jnp.float32)
                  .astype(xs.dtype).reshape(rows, m))
    return jnp.concatenate(ys) if chunks > 1 else ys[0]


#: the bf16 gap allowed between #17's twin (gate and up rounded to bf16
#: before silu, as the composed path's gmm2 rounds them) and the TPU
#: kernel's arithmetic (gate and up kept in fp32), scaled by max|y|: the
#: bf16 tier of tests/op_harness.py
KERNEL_GAP = 2e-2


@pytest.mark.parametrize("case", FUSED_BF16,
                         ids=[c["id"] for c in FUSED_BF16])
def test_fused_exchange_mlp_bf16_gap_to_jax_kernel(ranks, case):
    """#17's twin in bf16 (the CUDA kernel's numerics: gate and up rounded
    to bf16 before silu) against JAX in bf16: the composed
    ``_fused_exchange_mlp`` at the bf16 tier, in y and the gradients; and
    ``_fused_kernel``'s arithmetic, which keeps gate and up in fp32, within
    ``KERNEL_GAP`` of max|y|. The reference's own composed path departs
    from its kernel by the same rounding, so the twin's gap to the kernel
    must not exceed twice the reference's own. Measured at these shapes:
    0.42-0.93% of max|y| for the twin, 0.42-0.86% for the reference's
    composed path."""
    w = EP[case["mesh"]]
    jax_flags.set_flags({"moe_grouped_gemm": "on"})
    kw = dict(chunks=case["chunks"], bucket=case["bucket"],
              c_pad=case["c_pad"])
    args = [jnp.asarray(case[k], jnp.bfloat16 if k in ("x_send", "g", "u",
                                                       "d") else None)
            for k in ("x_send", "counts", "inv", "g", "u", "d")]
    composed = _shard_map(
        lambda xs, cn, iv, g, u, d: jax_a2a._fused_exchange_mlp(
            xs, cn, iv, g, u, d, ep_axis="ep", ep=w,
            block_m=case["block_m"], block_n=case["block_n"],
            ct=jnp.bfloat16, **kw), w, (P("ep"),) * 6, P("ep"))
    kernel = _shard_map(
        lambda xs, iv, g, u, d: _kernel_numerics(xs, iv, g, u, d, w=w, **kw),
        w, (P("ep"),) * 5, P("ep"))
    y = np.asarray(jax.jit(composed)(*args), np.float32)
    y_kernel = np.asarray(jax.jit(kernel)(args[0], *args[2:]), np.float32)
    cot = jnp.asarray(case["cot"])

    def loss(xs, g, u, d):
        return (composed(xs, args[1], args[2], g, u, d).astype(jnp.float32)
                * cot).sum()
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        args[0], *args[3:])
    got = _per_rank(ranks[3], case)
    twin = np.concatenate([g[0] for g in got])
    scale = np.abs(y_kernel).max()
    assert scale > 0
    np.testing.assert_allclose(twin, y, rtol=2e-2, atol=2e-2 * scale,
                               err_msg="y against the composed path")
    for i, name in enumerate(("dx_send", "dg", "du", "dd"), 1):
        want = np.asarray(grads[i - 1], np.float32)
        np.testing.assert_allclose(
            np.concatenate([g[i] for g in got]), want, rtol=6e-2,
            atol=2e-2 * max(np.abs(want).max(), 1), err_msg=name)
    gap = np.abs(twin - y_kernel).max() / scale
    own = np.abs(y - y_kernel).max() / scale
    assert gap <= KERNEL_GAP, (gap, own)
    assert gap <= 2 * own, (gap, own)
    # the port's mirror of the kernel's arithmetic, which the card's checks
    # hold #17 against, is JAX's (bit for bit at these shapes; allowed
    # one bf16 rounding of act)
    np.testing.assert_allclose(np.concatenate([g[5] for g in got]),
                               y_kernel, rtol=2 ** -7, atol=1e-3 * scale)


def _jax_run(layer, x_np):
    for p in layer.parameters():
        p.clear_gradient()
    x = paddle.to_tensor(x_np, stop_gradient=False)
    y = layer(x)
    loss = (y * y).sum() + layer.gate.get_loss()
    loss.backward()
    return (np.asarray(y._data), np.asarray(x.grad._data),
            {n: np.asarray(p.grad._data) for n, p in
             layer.named_parameters()})


@pytest.mark.parametrize("lid", list(LAYERS))
def test_moe_layer_ep_matches_jax_and_its_one_device_layer(ranks, lid):
    """The expert-parallel ``MoELayer`` (experts sharded, global routing,
    the a2a dispatch) under the fused and composed routes, with and
    without overlap (two chunks and four), at cf 1.0 (drops) and with
    experts no token reaches, with each flag's ``on`` and
    ``pallas_async_a2a=off`` (the collective exchange), and with all
    experts on every rank (the global mesh, no ``shard_experts``), once
    under ``moe_a2a_dispatch=off`` (the one-device path):
    y, dx and every gradient (the experts gathered back to ``[E, ...]``)
    against JAX's a2a path at the fp32 tier; y and dx bit for bit against
    the port's own one-device layer, the gradients within 1e-6."""
    mesh_name, experts, cf, _, overlap, _ = LAYERS[lid]
    cases, _, _, got = ranks
    case = cases[f"layer-{lid}"]
    w = EP[mesh_name]
    mesh = jdist.ProcessMesh(np.arange(w), ["ep"])
    jdist.set_mesh(mesh)
    jax_flags.set_flags({"moe_grouped_gemm": "on", "moe_a2a_dispatch": "on",
                         "moe_a2a_overlap": overlap})
    layer = _jax_layer(experts, cf)
    layer.shard_experts(mesh)
    y, dx, grads = _jax_run(layer, case["x"])
    for r in range(w):
        for name, res in got[r][case["id"]].items():
            msg = f"rank {r} {name}"
            _close(res["y"], y, msg + " y")
            _close(res["dx"], dx, msg + " dx")
            for n, g in grads.items():
                _close(res["grads"][n], g, f"{msg} {n}")
            assert res["y_equal_one"] and res["dx_equal_one"], msg
            scale = max(np.abs(g).max() for g in grads.values())
            assert res["grad_err_one"] <= 1e-6 * max(scale, 1.0), msg
            # every rank holds the same global result
            np.testing.assert_array_equal(res["y"],
                                          got[0][case["id"]][name]["y"])


@pytest.mark.parametrize("gid", list(GATHER))
def test_moe_layer_all_gather_matches_jax_and_its_one_device_layer(ranks,
                                                                   gid):
    """The all-gather expert path over sharded experts (the a2a path off):
    every rank fills the whole expert-major buffer from the replicated
    tokens, runs its block of the experts and all-gathers the outputs; the
    backward all-gathers the buffer's gradient. In the index form
    (``moe_grouped_gemm=off``, ``moe_a2a_dispatch=auto``; SwiGLU and bias
    ``Linear`` experts) and the grouped form (``on`` with ``off``), at ep 2
    and 4, at cf 1.0 (drops) and under ``recompute_interval``: y, dx and
    every gradient (the experts gathered back to ``[E, ...]``) against
    JAX's GSPMD path on the CPU mesh at the fp32 tier, every rank the same
    y; y and dx bit for bit against the port's one-device layer under the
    same flags, the gradients within 1e-6."""
    mesh_name, _, _, _, _, flag_set = GATHER[gid]
    cases, _, _, got = ranks
    case = cases[f"gather-{gid}"]
    w = EP[mesh_name]
    mesh = jdist.ProcessMesh(np.arange(w), ["ep"])
    jdist.set_mesh(mesh)
    jax_flags.set_flags(flag_set)
    layer = _jax_gather_layer(gid)
    layer.shard_experts(mesh)
    y, dx, grads = _jax_run(layer, case["x"])
    scale = max(np.abs(g).max() for g in grads.values())
    for r in range(w):
        res = got[r][case["id"]]
        msg = f"rank {r}"
        _close(res["y"], y, msg + " y")
        _close(res["dx"], dx, msg + " dx")
        for n, g in grads.items():
            _close(res["grads"][n], g, f"{msg} {n}")
        assert res["y_equal_one"] and res["dx_equal_one"], msg
        assert res["grad_err_one"] <= 1e-6 * max(scale, 1.0), msg
        np.testing.assert_array_equal(res["y"], got[0][case["id"]]["y"])
        np.testing.assert_array_equal(res["dx"], got[0][case["id"]]["dx"])


def test_moe_llama_ep_matches_jax_and_trains(ranks):
    """A 2-layer MoE Llama at ep 2, its experts sharded by
    ``llama_shard_fn`` and filled by ``load_jax_state`` with this rank's
    block of the JAX arrays: the loss within 1e-5 of JAX's a2a model and
    every gradient (experts gathered) at the fp32 tier; three ``to_static``
    AdamW steps over the sharded experts fall and leave the same bits in
    every parameter on both ranks (no all-reduce: the replicated
    parameters get the same gradient bits on every rank)."""
    _, jm, llama, got = ranks
    jdist.set_mesh(jdist.ProcessMesh(np.arange(2), ["ep"]))
    jax_flags.set_flags({"moe_grouped_gemm": "on", "moe_a2a_dispatch": "on"})
    ids = paddle.to_tensor(llama["ids"])
    loss, _ = jm(ids, labels=ids)
    loss.backward()
    res = got[0]["llama"]
    np.testing.assert_allclose(float(res["loss"]), float(loss.numpy()),
                               rtol=0, atol=1e-5)
    jgrads = dict(jm.named_parameters())
    for name, g in res["grads"].items():
        _close(g, jgrads[name].grad.numpy(), name)
    experts = [n for n in res["shapes"] if ".stacked." in n]
    assert experts and all(res["shapes"][n][0] == 2 for n in experts)
    losses = [float(x) for x in res["losses"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    other = got[1]["llama"]
    assert [x.tobytes() for x in other["losses"]] == \
        [x.tobytes() for x in res["losses"]]
    assert other["digest"] == res["digest"]


def test_eligibility_matches_jax():
    """The structural eligibility rules and their reasons, as the
    reference states them."""
    meshes = [None, (np.arange(4), ["dp"]), (np.arange(1), ["ep"]),
              (np.arange(4), ["ep"]), (np.arange(8).reshape(2, 4),
                                       ["dp", "ep"]),
              (np.arange(8).reshape(2, 2, 2), ["dp", "ep", "mp"]),
              (np.arange(4).reshape(2, 2), ["pp", "ep"])]
    for spec in meshes:
        for e, n, ffn in ((8, 128, 64), (6, 128, 64), (8, 6, 64),
                          (8, 128, 63)):
            jm = None if spec is None else jdist.ProcessMesh(*spec)
            pm = None if spec is None else pdist.ProcessMesh(*spec)
            assert moe_a2a.a2a_ineligible_reason(pm, "ep", e, n, ffn) == \
                jax_a2a.a2a_ineligible_reason(jm, "ep", e, n, ffn), spec


def test_a2a_flag_values():
    """``on`` is an alias of ``auto`` for the two kernel flags;
    ``moe_a2a_dispatch``'s ``on`` forces the a2a path and its ``auto``
    follows ``moe_grouped_gemm`` (the reference's rule); ``off`` turns
    each route off; any other value raises."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    gates = {"moe_a2a_dispatch": moe_a2a.a2a_enabled,
             "pallas_async_a2a": hops.async_a2a_enabled,
             "moe_a2a_fused_kernel": hops.fused_kernel_enabled}
    try:
        for grouped in ("auto", "off"):
            flags.set_flags({"moe_grouped_gemm": grouped})
            for name, gate in gates.items():
                follows = name != "moe_a2a_dispatch" or grouped != "off"
                for value, want in (("auto", follows), ("on", True),
                                    ("ON", True), ("off", False)):
                    flags.set_flags({name: value})
                    assert gate() is want, (grouped, name, value)
                flags.set_flags({name: "sometimes"})
                with pytest.raises(ValueError, match=name):
                    gate()
                flags.set_flags({name: "auto"})
    finally:
        flags.set_flags({name: "auto" for name in gates})
        flags.set_flags({"moe_grouped_gemm": "auto"})


def test_async_a2a_off_refuses_device_tensors():
    """``pallas_async_a2a=off`` takes the collective exchange on CPU
    tensors only: a tensor off the CPU raises rather than moving through
    the host (the card's case is in ``tests/test_torch_cuda.py``)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import collective as coll
    x = torch.arange(6.).reshape(3, 2)
    flags.set_flags({"pallas_async_a2a": "off"})
    try:
        assert torch.equal(coll._tiled_exchange(x, None), x)
        assert torch.equal(coll.ragged_all_to_all(x), x)
        with pytest.raises(NotImplementedError, match="pallas_async_a2a=off"):
            coll._tiled_exchange(torch.zeros(3, 2, device="meta"), None)
        with pytest.raises(NotImplementedError, match="pallas_async_a2a=off"):
            coll.ragged_all_to_all(torch.zeros(3, 2, device="meta"))
    finally:
        flags.set_flags({"pallas_async_a2a": "auto"})


def test_expert_parallel_refuses_what_is_not_ported():
    """Axes beside ep (A.10) raise; the list form of all_to_all validates
    as the reference's does; ragged_all_to_all needs a bucket and a packed
    buffer that splits."""
    from paddle_tpu_torch.distributed import collective as coll
    dp_ep = pdist.ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "ep"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
        moe_a2a.require_ep_only(dp_ep, "ep", "MoE")
    with pytest.raises(ValueError, match="one input tensor per rank"):
        coll.all_to_all([], [torch.zeros(2), torch.zeros(2)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
        coll.all_to_all(torch.zeros(2))
    with pytest.raises(ValueError, match="bucket"):
        coll.ragged_all_to_all(torch.zeros(4, 2), torch.zeros(4,
                                                              dtype=torch.int32))
    with pytest.raises(ValueError, match="not a multiple"):
        coll.ragged_all_to_all(torch.zeros(3, 2), world=2)
    # a world of one: the exchange is the identity
    x = torch.arange(6.).reshape(3, 2)
    assert torch.equal(coll.ragged_all_to_all(x), x)
    assert torch.equal(coll.all_to_all([], [x])[0], x)
