"""The port's context-parallel ring against the JAX ring.

The port's ring runs in four spawned CPU ranks over a gloo group
(``tests/_torch_cp_ranks.py``; spawned once for the module, ~15 s): a
``["sep"]`` mesh of four ranks (sp 4) and a ``["dp", "sep"]`` 2x2 mesh
(sp 2 in each dp row). Every rank holds the same global q, k and v and
gets the global output and gradients back. The JAX ring runs in this
process on the 8-device CPU mesh of ``tests/conftest.py`` at the same sp,
on the same numpy inputs, its kernels in Pallas interpret mode. Layouts
``contig``, ``zigzag`` and ``zigzag_pre`` (the caller keeps the sequence
in ``zigzag_order``), causal with GQA 4:2 and non-causal; output and the
three gradients at ``atol=5e-5``, the JAX ring tests' own
(``tests/test_sequence_parallel.py:82``). Then a tiny sep Llama with the
JAX model's weights (``load_jax_state``): loss within 1e-5 of the JAX sep
model's, as ``test_sequence_parallel.py:277``, gradients at ``atol=5e-5``,
and three ``to_static`` AdamW steps that fall and are the same bits on
every rank.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.models import llama as jax_llama

import _torch_cp_ranks
import paddle_tpu_torch.distributed as pdist
from paddle_tpu_torch.models import LlamaConfig

B, S, H, HK, D = 2, 32, 4, 2, 16
RING_TOL = dict(rtol=0, atol=5e-5)
MESHES = {"sep4": ([0, 1, 2, 3], ["sep"]),
          "dp2xsep2": ([[0, 1], [2, 3]], ["dp", "sep"])}
SP = {"sep4": 4, "dp2xsep2": 2}


def _ring_cases():
    cases = []
    for mesh in MESHES:
        for causal, hk, layouts in ((True, HK, ("contig", "zigzag",
                                                "zigzag_pre")),
                                    (False, H, ("contig", "zigzag"))):
            for layout in layouts:
                seed = len(cases)
                rng = np.random.RandomState(seed)
                qkv = [rng.randn(B, S, h, D).astype(np.float32)
                       for h in (H, hk, hk)]
                cases.append(dict(id=f"{mesh}-{layout}-"
                                  f"{'causal' if causal else 'full'}",
                                  mesh=mesh, causal=causal, layout=layout,
                                  qkv=qkv))
    return cases


RING = _ring_cases()


def _rotate_cases():
    cases = []
    for mesh in MESHES:
        for hk in (HK, 3):
            rng = np.random.RandomState(100 + len(cases))
            kv = [rng.randn(B, S, hk, D).astype(np.float32)
                  for _ in range(2)]
            cases.append(dict(id=f"rotate-{mesh}-kv{hk}", mesh=mesh, kv=kv))
    return cases


ROTATE = _rotate_cases()


def _llama_spec():
    paddle.seed(0)
    jcfg = jax_llama.llama_tiny_config(
        num_hidden_layers=2, hidden_size=64, intermediate_size=128,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=128,
        sequence_parallel=True, sep_mode="auto")
    jm = jax_llama.LlamaForCausalLM(jcfg)
    names = {f.name for f in dataclasses.fields(LlamaConfig)}
    config = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name in names}
    ids = np.random.RandomState(2).randint(0, 128, size=(2, S)) \
        .astype(np.int32)
    weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, dict(mesh="dp2xsep2", config=config, weights=weights, ids=ids)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: one spawn of four gloo ranks for the module."""
    work = tmp_path_factory.mktemp("cp_ranks")
    jm, llama = _llama_spec()
    torch.save(dict(meshes=MESHES, ring=RING, rotate=ROTATE, llama=llama),
               work / "spec.pt")
    pdist.spawn(_torch_cp_ranks.run, (str(work),), nprocs=4, timeout=600)
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    return jm, llama, got


@pytest.fixture
def jax_mesh():
    """Set the JAX mesh of a given sp over the 8 CPU devices."""
    def make(sp):
        mesh = jdist.ProcessMesh(np.arange(8).reshape(8 // sp, sp),
                                 ["dp", "sep"])
        jdist.set_mesh(mesh)
        return mesh
    yield make
    jdist.set_mesh(None)


def _jax_ring(case, mesh):
    """The JAX ring's output and gradients for ``mean(out * out)``."""
    q, k, v = (paddle.to_tensor(x, stop_gradient=False) for x in case["qkv"])
    causal, layout = case["causal"], case["layout"]
    if layout == "zigzag_pre":
        out = jdist.zigzag_gather(jdist.ring_attention(
            *(jdist.zigzag_scatter(x, mesh) for x in (q, k, v)),
            causal=causal, layout="zigzag_pre"), mesh)
    else:
        out = jdist.ring_attention(
            *(jdist.sequence_scatter(x, mesh) for x in (q, k, v)),
            causal=causal, layout=layout)
    paddle.mean(out * out).backward()
    return [x.numpy() for x in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("case", RING, ids=[c["id"] for c in RING])
def test_ring_matches_jax_ring(ranks, jax_mesh, case):
    _, _, got = ranks
    want = _jax_ring(case, jax_mesh(SP[case["mesh"]]))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[0][case["id"]],
                          want):
        np.testing.assert_allclose(a, b, err_msg=name, **RING_TOL)
    # every rank holds the same global result, bit for bit
    for r in range(1, 4):
        for a, b in zip(got[r][case["id"]], got[0][case["id"]]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ROTATE, ids=[c["id"] for c in ROTATE])
def test_ring_kv_rotate_matches_jax(ranks, jax_mesh, case):
    """One KV hop (the port of ``ring_kv_rotate``; CPU tensors take its
    stacked-``ppermute`` twin) against the JAX ring's ``_ring_rotate``
    under ``shard_map``: every rank receives its predecessor's shard."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec
    from paddle_tpu.distributed import sequence_parallel as jsp
    _, _, got = ranks
    sp = SP[case["mesh"]]
    mesh = jax_mesh(sp)
    spec = PartitionSpec(None, "sep", None, None)
    perm = [(j, (j + 1) % sp) for j in range(sp)]
    fn = jsp._shard_mapped(lambda k, v: jsp._ring_rotate(k, v, "sep", perm),
                           mesh, "sep", (spec, spec), (spec, spec))
    want = [np.asarray(x) for x in fn(*(jnp.asarray(x) for x in case["kv"]))]
    n = S // sp
    ids = np.asarray(MESHES[case["mesh"]][0])
    for r in range(4):
        idx = int(np.argwhere(ids == r)[0][-1])      # the rank's sep index
        for a, b in zip(got[r][case["id"]], want):
            np.testing.assert_array_equal(a, b[:, idx * n:(idx + 1) * n])


def test_ring_kv_rotate_refuses_other_devices():
    """A tensor neither on the CPU (the twin) nor on a card (the kernel)
    is refused: nothing falls back."""
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    meta = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        hops.ring_kv_rotate(meta, meta, [(0, 0)])


def test_sep_llama_matches_jax_and_trains(ranks, jax_mesh):
    jm, llama, got = ranks
    jax_mesh(2)
    ids = paddle.to_tensor(llama["ids"])
    loss, _ = jm(ids, labels=ids)
    loss.backward()
    jgrads = dict(jm.named_parameters())
    res = got[0]["llama"]
    np.testing.assert_allclose(float(res["loss"]), float(loss.numpy()),
                               rtol=0, atol=1e-5)
    for name, g in res["grads"].items():
        np.testing.assert_allclose(g, jgrads[name].grad.numpy(),
                                   err_msg=name, **RING_TOL)
    losses = [float(x) for x in res["losses"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    for r in range(1, 4):
        other = got[r]["llama"]
        assert [x.tobytes() for x in other["losses"]] == \
            [x.tobytes() for x in res["losses"]]
        assert other["digest"] == res["digest"]


def test_ring_error_cases():
    """The reference's errors: no mesh, no sep axis, a bad layout, a
    sequence the zig-zag layout cannot split."""
    q = torch.zeros(1, 12, 2, 8)
    pdist.set_mesh(None)
    with pytest.raises(ValueError, match="needs a mesh"):
        pdist.ring_attention(q, q, q, True)
    with pytest.raises(ValueError, match="no 'sep' axis"):
        pdist.ring_attention(q, q, q, True, mesh=pdist.ProcessMesh([0],
                                                                   ["dp"]))
    mesh = pdist.ProcessMesh([0, 1, 2, 3], ["sep"])
    with pytest.raises(ValueError, match="layout"):
        pdist.ring_attention(q, q, q, True, mesh=mesh, layout="wave")
    with pytest.raises(ValueError, match="divisible"):
        pdist.ring_attention(q, q, q, True, mesh=mesh, layout="zigzag")


def test_sp1_is_plain_attention():
    """A sep axis of one rank runs plain flash attention, differentiable."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(2, 8, h, 16).astype(np.float32))
               for h in (4, 2, 2))
    mesh = pdist.ProcessMesh([[0]], ["dp", "sep"])
    out = pdist.ring_attention(q, k, v, True, mesh=mesh, layout="zigzag")
    ref = fa.flash_attention(q, k, v, True)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("name", ["ulysses_attention", "sequence_scatter",
                                  "sequence_gather", "zigzag_scatter",
                                  "zigzag_gather"])
def test_unported_sequence_parallel_raises(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.10"):
        getattr(pdist, name)(torch.zeros(1, 4, 2, 8))


def test_zigzag_order_and_flops_match_jax():
    for s, sp in ((32, 2), (32, 4), (64, 8)):
        np.testing.assert_array_equal(pdist.zigzag_order(s, sp),
                                      jdist.zigzag_order(s, sp))
        for causal in (True, False):
            for layout in ("zigzag", "contig"):
                assert pdist.ring_attention_flops(s, sp, causal, layout) == \
                    jdist.ring_attention_flops(s, sp, causal, layout)


def test_mesh_surface():
    mesh = pdist.ProcessMesh([[0, 1], [2, 3]], ["dp", "sep"])
    assert mesh.shape == [2, 2] and mesh.get_dim_size("sep") == 2
    assert mesh.process_ids == [0, 1, 2, 3]
    sub = mesh.get_mesh_with_dim("sep", 1)
    assert sub.dim_names == ["dp"] and sub.process_ids == [1, 3]
    with pytest.raises(RuntimeError, match="set_mesh"):
        mesh.group("sep")
    # one process, no group: a mesh naming ranks outside the world refuses
    with pytest.raises(ValueError, match="outside the world"):
        pdist.set_mesh(mesh)
    assert pdist.get_mesh() is None
    one = pdist.ProcessMesh([0], ["sep"])
    with one:
        assert pdist.get_mesh() is one and one.group("sep") is None
        assert one.axis_index("sep") == 0
    assert pdist.get_mesh() is None
