"""Rank bodies of ``tests/test_torch_sequence_parallel.py`` (:func:`run`)
and of the KV-hop case of ``tests/test_torch_cuda.py`` (:func:`hop_run`).

Each spawned rank joins a gloo group, sets the meshes of the test module's
spec in order (every rank the same order, as ``new_group`` requires), runs
its cases through the port's ring on CPU tensors and writes what it got to
``rank{r}.pt`` in the work directory. This module imports torch and the
port only: the JAX reference runs in the test process.
"""

import hashlib
import os

import numpy as np
import torch


def _ring_case(dist, mesh, case):
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in case["qkv"])
    causal, layout = case["causal"], case["layout"]
    if layout == "zigzag_pre":
        # the caller keeps the sequence in zig-zag order
        order = torch.from_numpy(dist.zigzag_order(
            q.shape[1], mesh.get_dim_size("sep"))).long()
        inv = torch.argsort(order)
        out = dist.ring_attention(q[:, order], k[:, order], v[:, order],
                                  causal, layout=layout)[:, inv]
    else:
        out = dist.ring_attention(q, k, v, causal, layout=layout)
    (out * out).mean().backward()
    return [x.detach().numpy() for x in (out, q.grad, k.grad, v.grad)]


def _ring_perm(sp):
    return [(j, (j + 1) % sp) for j in range(sp)]


def _rotate_case(mesh, case):
    """The rank's contiguous shard of the global k and v, one hop round
    the mesh's sep ring."""
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    sp, idx = mesh.get_dim_size("sep"), mesh.axis_index("sep")
    n = case["kv"][0].shape[1] // sp
    k, v = (torch.from_numpy(x[:, idx * n:(idx + 1) * n].copy())
            for x in case["kv"])
    ko, vo = hops.ring_kv_rotate(k, v, _ring_perm(sp), mesh.group("sep"))
    return [ko.numpy(), vo.numpy()]


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def _llama_case(case):
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.weights import load_jax_state
    model = LlamaForCausalLM(LlamaConfig(**case["config"]), device="cpu")
    load_jax_state(model, case["weights"])
    ids = torch.from_numpy(case["ids"])
    loss, _ = model(ids, labels=ids)
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
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
    return dict(loss=loss.detach().numpy(), grads=grads, losses=losses,
                digest=_digest(model))


def run(rank, work_dir):
    import paddle_tpu_torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo")
    spec = torch.load(os.path.join(work_dir, "spec.pt"), weights_only=False)
    got = {}
    for name, (ids, dims) in spec["meshes"].items():
        mesh = dist.ProcessMesh(np.asarray(ids), dims)
        dist.set_mesh(mesh)
        for case in spec["ring"]:
            if case["mesh"] == name:
                got[case["id"]] = _ring_case(dist, mesh, case)
        for case in spec["rotate"]:
            if case["mesh"] == name:
                got[case["id"]] = _rotate_case(mesh, case)
        if spec["llama"]["mesh"] == name:
            got["llama"] = _llama_case(spec["llama"])
    dist.set_mesh(None)
    torch.save(got, os.path.join(work_dir, f"rank{rank}.pt"))


def hop_run(rank, work_dir):
    """Two ranks sharing one card over gloo: the KV hop kernel against its
    twin (a gloo ``ppermute`` through the host), bitwise, for each case of
    ``hops.pt`` in order (the slots grow and alternate across them)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    env = dist.init_parallel_env(backend="gloo")
    group = dist.ProcessMesh([0, 1], ["sep"])
    dist.set_mesh(group)
    perm = _ring_perm(2)
    got = []
    for shape, dtype in torch.load(os.path.join(work_dir, "hops.pt")):
        g = torch.Generator().manual_seed(rank)
        k, v = (torch.randn(shape, generator=g).to(dtype).to(env.device)
                for _ in range(2))
        before = hops.launches
        out = hops.ring_kv_rotate(k, v, perm, group.group("sep"))
        launched = hops.launches - before
        want = hops.ring_kv_rotate_plain(k, v, perm, group.group("sep"))
        got.append(dict(equal=all(torch.equal(a, b)
                                  for a, b in zip(out, want)),
                        moved=not torch.equal(out[0], k),
                        launches=launched))
    dist.set_mesh(None)
    torch.save(got, os.path.join(work_dir, f"hop{rank}.pt"))
