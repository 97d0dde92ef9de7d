"""Rank bodies of ``tests/test_torch_moe_a2a.py`` (:func:`run`) and of the
exchange cases of ``tests/test_torch_cuda.py`` (:func:`a2a_cuda_run`,
:func:`fused_cuda_run`).

Each spawned rank joins a gloo group, sets the meshes of the spec in order
(every rank the same order, as ``new_group`` requires), runs the cases of
the meshes it belongs to through the port and writes what it got to
``rank{r}.pt`` in the work directory. This module imports torch and the
port only: the JAX reference runs in the test process.
"""

import hashlib
import os

import numpy as np
import torch


def _flags(values):
    from paddle_tpu_torch import flags
    old = {k: flags.flag(k) for k in values}
    flags.set_flags(values)
    return old


def _rows(x, w, r):
    n = x.shape[0] // w
    return x[r * n:(r + 1) * n]


def _ragged_case(mesh, case):
    """``ragged_all_to_all`` dispatch -> return exchange -> gather at
    ``send_pos``, and the gradient of half the sum of squares."""
    from paddle_tpu_torch.distributed import collective as coll
    w, r = mesh.get_dim_size("ep"), mesh.axis_index("ep")
    group = mesh.group("ep")
    dtype = getattr(torch, case["dtype"])
    x = torch.from_numpy(_rows(case["x"], w, r)).to(dtype).requires_grad_()
    dest = torch.from_numpy(_rows(case["dest"], w, r))
    meta = None if case["meta"] is None else torch.from_numpy(
        _rows(case["meta"], w, r))
    recv, recv_meta, send_pos = coll.ragged_all_to_all(
        x, dest, bucket=case["bucket"], group=group, world=w, meta=meta)
    back = coll.ragged_all_to_all(recv, group=group, world=w)
    got = send_pos >= 0
    out = back[torch.where(got, send_pos, 0).long()] \
        * got.to(back.dtype)[:, None]
    ((out.float() ** 2).sum() / 2).backward()
    return dict(out=out.detach().float().numpy(), grad=x.grad.float().numpy(),
                recv_meta=None if recv_meta is None else recv_meta.numpy(),
                send_pos=send_pos.numpy())


def _tiled_case(mesh, case):
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    w, r = mesh.get_dim_size("ep"), mesh.axis_index("ep")
    x = torch.from_numpy(_rows(case["x"], w, r))
    if case["dtype"] == "bfloat16":
        x = x.bfloat16()
    group = mesh.group("ep")
    outs = [hops.tiled_a2a(x, group), hops.tiled_a2a_plain(x, group),
            coll.tiled_all_to_all(x, group)]
    return [o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy()
            for o in outs]


def fused_tpu_numerics(x_send, counts, inv, wg, wu, wd, *, group, chunks,
                       bucket, c_pad):
    """#17 with the TPU kernel's arithmetic (``_fused_kernel``,
    ``paddle_tpu/ops/pallas/async_collectives.py:464-476``): the exchange
    and the ``inv`` gather of the twin, then gate and up kept in fp32,
    ``silu(g) * u`` rounded once to the compute dtype, the down projection
    accumulated in fp32 and rounded on the store. The port's kernel and
    twin round gate and up to the compute dtype first (ROADMAP.md C); this
    measures that departure."""
    import torch.nn.functional as F
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    e_local = wg.shape[0]
    wb = collective._world(group)[1] * bucket
    rows = e_local * c_pad
    ys = []
    for c in range(chunks):
        recv = hops.tiled_a2a_plain(x_send[c * wb:(c + 1) * wb], group)
        ic = inv[c * rows:(c + 1) * rows].long()
        live = ic < wb
        xb = (F.embedding(torch.where(live, ic, torch.zeros_like(ic)), recv)
              * live.to(recv.dtype)[:, None]).float().reshape(e_local, c_pad,
                                                               -1)
        act = (F.silu(torch.bmm(xb, wg.float()))
               * torch.bmm(xb, wu.float())).to(x_send.dtype)
        ys.append(torch.bmm(act.float(), wd.float()).to(x_send.dtype)
                  .reshape(rows, -1))
    return ys[0] if chunks == 1 else torch.cat(ys)


def _fused_case(mesh, case):
    """#17's twin under its autograd Function: the output, and the
    gradients of ``sum(y * cot)``; in bf16 also the output with the TPU
    kernel's arithmetic (:func:`fused_tpu_numerics`)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_a2a
    w, r = mesh.get_dim_size("ep"), mesh.axis_index("ep")
    dtype = getattr(torch, case["dtype"])
    leaves = [torch.from_numpy(_rows(case[k], w, r)).to(dtype)
              .requires_grad_() for k in ("x_send", "g", "u", "d")]
    counts = torch.from_numpy(_rows(case["counts"], w, r))
    inv = torch.from_numpy(_rows(case["inv"], w, r))
    plan = moe_a2a._Plan(group=mesh.group("ep"), ep=w, idx=r, num_e=0,
                         e_local=0, n_l=0, c_pad=case["c_pad"],
                         chunks=case["chunks"], bucket=case["bucket"],
                         fused=True, full=False)
    y = moe_a2a._FusedExchangeMlp.apply(leaves[0], counts, inv, *leaves[1:],
                                        plan)
    (y.float() * torch.from_numpy(_rows(case["cot"], w, r))).sum() \
        .backward()
    out = [y.detach().float().numpy()] + [x.grad.float().numpy()
                                          for x in leaves]
    if dtype != torch.float32:
        with torch.no_grad():
            out.append(fused_tpu_numerics(
                leaves[0], counts, inv, *leaves[1:], group=plan.group,
                chunks=plan.chunks, bucket=plan.bucket, c_pad=plan.c_pad)
                .float().numpy())
    return out


def _layer(case, generator_seed=0):
    """The case's layer: SwiGLU experts, or bias ``Linear`` experts where
    ``case["expert"]`` says ``linear``; ``recompute_interval`` from the
    case; the JAX weights loaded."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.weights import load_jax_state
    cfg = L.LlamaConfig(hidden_size=case["hidden"],
                        intermediate_size=case["ffn"])
    init = L._Init(cfg, torch.device("cpu"),
                   torch.Generator().manual_seed(generator_seed))
    if case.get("expert", "mlp") == "linear":
        experts = [pnn.Linear(case["hidden"], case["hidden"], bias=True)
                   for _ in range(case["experts"])]
    else:
        experts = [L.LlamaMLP(cfg, init) for _ in range(case["experts"])]
    layer = moe.MoELayer(case["hidden"], experts, gate="gshard",
                         capacity_factor=case["cf"],
                         recompute_interval=case.get("recompute", 0))
    load_jax_state(layer, case["weights"])
    return layer


def _run_layer(layer, x_np):
    x = torch.from_numpy(x_np).requires_grad_()
    y = layer(x)
    loss = (y * y).sum() + layer.gate.get_loss()
    loss.backward()
    grads = {n: p.grad for n, p in layer.named_parameters()}
    return y.detach(), x.grad, grads


def _layer_case(mesh, case):
    """The expert-parallel ``MoELayer`` under each flag setting of the
    case, against the same layer on the one-device path (bitwise in y and
    dx); the expert gradients gathered back to ``[E, ...]``. A setting
    named ``full...`` keeps all E experts on every rank (no
    ``shard_experts``: each rank runs its block and the experts' gradients
    are all-gathered)."""
    from paddle_tpu_torch.weights import gather_experts
    one = _layer(case)
    one._mesh = type(mesh)([0], ["ep"])          # ep 1: the one-device path
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        y1, dx1, g1 = _run_layer(one, case["x"])
    out = {}
    for name, values in case["flags"].items():
        old = _flags(values)
        try:
            layer = _layer(case)
            if not name.startswith("full"):
                layer.shard_experts(mesh)
            y, dx, g = _run_layer(layer, case["x"])
            g = gather_experts(layer, g)
        finally:
            _flags(old)
        out[name] = dict(
            y=y.numpy(), dx=dx.numpy(),
            grads={n: t.numpy() for n, t in g.items()},
            y_equal_one=torch.equal(y, y1), dx_equal_one=torch.equal(dx, dx1),
            grad_err_one=max(float((g[n] - g1[n]).abs().max()) for n in g1))
    return out


def _gather_case(mesh, case):
    """The all-gather expert path over sharded experts: under the case's
    flags (the a2a path off), the layer keeping this rank's block of the
    experts against the same layer holding all of them on one device under
    the same flags (bitwise in y and dx); the experts' gradients gathered
    back to ``[E, ...]``."""
    from paddle_tpu_torch.weights import gather_experts
    old = _flags(case["flags"])
    try:
        one = _layer(case)
        one._mesh = type(mesh)([0], ["ep"])      # ep 1: the one-device path
        y1, dx1, g1 = _run_layer(one, case["x"])
        layer = _layer(case).shard_experts(mesh)
        y, dx, g = _run_layer(layer, case["x"])
        g = gather_experts(layer, g)
    finally:
        _flags(old)
    return dict(
        y=y.numpy(), dx=dx.numpy(),
        grads={n: t.numpy() for n, t in g.items()},
        y_equal_one=torch.equal(y, y1), dx_equal_one=torch.equal(dx, dx1),
        grad_err_one=max(float((g[n] - g1[n]).abs().max()) for n in g1))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.detach().float().numpy().tobytes())
    return h.hexdigest()


def _llama_case(mesh, case):
    """A tiny MoE Llama with its experts sharded over ep
    (``llama_shard_fn``) and the JAX weights loaded into the shards: the
    loss and gathered gradients, then three ``to_static`` AdamW steps."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_shard_fn)
    from paddle_tpu_torch.weights import gather_experts, load_jax_state
    model = LlamaForCausalLM(LlamaConfig(**case["config"]), device="cpu")
    dist.shard_layer(model, mesh, llama_shard_fn(mesh))
    load_jax_state(model, case["weights"])
    ids = torch.from_numpy(case["ids"])
    loss, _ = model(ids, labels=ids)
    loss.backward()
    grads = gather_experts(model, {n: p.grad for n, p in
                                   model.named_parameters()})
    model.zero_grad(set_to_none=True)
    opt = optimizer.AdamW(learning_rate=1e-3, weight_decay=0.1,
                          parameters=model.parameters())

    @jit.to_static
    def step(x):
        step_loss, _ = model(x, labels=x)
        step_loss.backward()
        opt.step()
        opt.clear_grad()
        return step_loss.detach()

    losses = [step(ids).numpy() for _ in range(3)]
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return dict(loss=loss.detach().numpy(),
                grads={n: g.numpy() for n, g in grads.items()},
                losses=losses, shapes=shapes,
                digest=_digest(gather_experts(model)))


def run(rank, work_dir):
    import paddle_tpu_torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo")
    spec = torch.load(os.path.join(work_dir, "spec.pt"), weights_only=False)
    kinds = dict(ragged=_ragged_case, tiled=_tiled_case, fused=_fused_case,
                 layer=_layer_case, llama=_llama_case, gather=_gather_case)
    got = {}
    for name, (ids, dims) in spec["meshes"].items():
        mesh = dist.ProcessMesh(np.asarray(ids), dims)
        dist.set_mesh(mesh)
        if rank not in ids:
            continue
        for case in spec["cases"]:
            if case["mesh"] == name:
                got[case["id"]] = kinds[case["kind"]](mesh, case)
    dist.set_mesh(None)
    torch.save(got, os.path.join(work_dir, f"rank{rank}.pt"))


# ----------------------------------------------------------- on the card
def a2a_cuda_run(rank, work_dir):
    """Ranks sharing one card over gloo: the tiled all-to-all kernel (#15)
    against its twin (the gloo exchange through the host), bit for bit,
    for each case of ``a2a.pt`` in order, with a KV hop (#16) between
    cases so that the exchanges share the slots; the launches of each."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    env = dist.init_parallel_env(backend="gloo")
    w = dist.get_world_size()
    mesh = dist.ProcessMesh(list(range(w)), ["ep"])
    dist.set_mesh(mesh)
    group = mesh.group("ep")
    got = []
    for shape, dtype in torch.load(os.path.join(work_dir, "a2a.pt")):
        g = torch.Generator().manual_seed(rank)
        x = (torch.randn(shape, generator=g) * 100).to(dtype).to(env.device)
        before = hops.launches_a2a
        out = hops.tiled_a2a(x, group)
        launched = hops.launches_a2a - before
        want = hops.tiled_a2a_plain(x, group)
        k = torch.randn(1, 8, 2, 8, generator=g).to(env.device)
        ko, _ = hops.ring_kv_rotate(k, k, [(j, (j + 1) % w)
                                           for j in range(w)], group)
        ko_want, _ = hops.ring_kv_rotate_plain(
            k, k, [(j, (j + 1) % w) for j in range(w)], group)
        got.append(dict(equal=torch.equal(out, want),
                        hop_equal=torch.equal(ko, ko_want),
                        moved=w == 1 or not torch.equal(out, x),
                        launches=launched))
    dist.set_mesh(None)
    torch.save(got, os.path.join(work_dir, f"a2a{rank}.pt"))


def fused_inputs(mesh, tokens, experts, hidden, ffn, cf, chunks, dtype,
                 device, seed=0, empty_expert=None):
    """The path's own inputs of #17 on this rank: global tokens and a
    gshard routing over them (``empty_expert``: no token routes there),
    this rank's rows packed for each chunk (``_pack_for_fused``), the
    rank's block of random expert weights. Returns ``(x_send, counts, inv,
    wg, wu, wd, plan)``."""
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_a2a
    r = mesh.axis_index("ep")
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tokens, hidden, generator=g, device=device)
    gate = moe.GShardGate(hidden, experts, device=device, generator=g)
    scores = (x @ gate.weight).float()
    if empty_expert is not None:
        scores[:, empty_expert] = -1e9
    capacity = gate.capacity(tokens, cf, 2)
    e_idx, _, _, keep, _ = gate.route_indices(scores, capacity)
    plan = moe_a2a._plan(mesh, "ep", experts, tokens, 2, capacity,
                         chunks=chunks)
    rows = slice(r * plan.n_l, (r + 1) * plan.n_l)
    x_send, counts, inv, _ = moe_a2a._pack_chunks(
        x[rows].to(dtype), e_idx[rows], keep[rows], plan)
    e_l = plan.e_local
    wg, wu = (torch.randn(experts, hidden, ffn, generator=g, device=device)
              [r * e_l:(r + 1) * e_l].mul(hidden ** -0.5).to(dtype)
              for _ in range(2))
    wd = torch.randn(experts, ffn, hidden, generator=g, device=device)[
        r * e_l:(r + 1) * e_l].mul(ffn ** -0.5).to(dtype)
    return x_send, counts, inv, wg, wu, wd, plan


def fused_cuda_run(rank, work_dir):
    """Ranks sharing one card: the comm-fused kernel (#17) against its twin
    on the path's own packed inputs, each case of ``fused.pt``: the
    largest error scaled by the twin's largest magnitude, the same against
    the TPU kernel's arithmetic (:func:`fused_tpu_numerics`), a second
    launch bitwise, one launch a call."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    torch.backends.cuda.matmul.allow_tf32 = False
    env = dist.init_parallel_env(backend="gloo")
    mesh = dist.ProcessMesh(list(range(dist.get_world_size())), ["ep"])
    dist.set_mesh(mesh)
    got = []
    for case in torch.load(os.path.join(work_dir, "fused.pt")):
        x_send, counts, inv, wg, wu, wd, plan = fused_inputs(
            mesh, device=env.device, **case)
        kw = dict(group=plan.group, chunks=plan.chunks, bucket=plan.bucket,
                  c_pad=plan.c_pad)
        before = hops.launches_fused
        y = hops.fused_a2a_expert_mlp(x_send, counts, inv, wg, wu, wd, **kw)
        again = hops.fused_a2a_expert_mlp(x_send, counts, inv, wg, wu, wd,
                                          **kw)
        launched = hops.launches_fused - before
        want = hops.fused_a2a_expert_mlp_plain(x_send, counts, inv, wg, wu,
                                               wd, **kw)
        tpu = fused_tpu_numerics(x_send, counts, inv, wg, wu, wd, **kw)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        got.append(dict(err=float((y.float() - want.float()).abs().max())
                        / max(scale, 1e-30), scale=scale,
                        tpu_gap=float((y.float() - tpu.float()).abs().max())
                        / max(float(tpu.float().abs().max()), 1e-30),
                        bitwise=torch.equal(y, again), launches=launched,
                        live=int(counts.sum()),
                        empty=int((counts == 0).sum())))
    dist.set_mesh(None)
    torch.save(got, os.path.join(work_dir, f"fused{rank}.pt"))
