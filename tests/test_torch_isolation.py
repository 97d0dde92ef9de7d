"""The port stands alone: no JAX and no ``paddle_tpu`` inside it, CUDA by
default with no silent CPU fallback, and every unported option refused
by name."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.inference import GenerationEngine
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.ops.kernels import rms_norm as pt_rms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_jax_or_reference_import_in_the_port():
    files = list(_port_files())
    assert len(files) > 20 and all(os.path.exists(f) for f in files)
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {"paddle_tpu_torch/quantization/kv.py",
            "paddle_tpu_torch/quantization/observers.py",
            "paddle_tpu_torch/ops/kernels/quant.py"} <= rel
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch.inference, paddle_tpu_torch.models,"
            " paddle_tpu_torch.weights, paddle_tpu_torch.ops.kernels, "
            "paddle_tpu_torch.quantization; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_cuda_and_absence_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(llama_tiny_config())
    assert resolve_device("cpu") == torch.device("cpu")
    m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    assert m.device == torch.device("cpu")


def test_wrappers_do_not_fall_back_off_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device gets an
    error, never the plain twin."""
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pt_rms.rms_norm(x, torch.empty(64, device="meta"))


@pytest.fixture(scope="module")
def tiny():
    return LlamaForCausalLM(llama_tiny_config(), device="cpu")


@pytest.mark.parametrize("kwargs", [
    dict(mode="eager", spec_tokens=2), dict(spec_tokens=2),
    dict(prefix_cache=True), dict(host_tier=True)])
def test_unported_engine_options_raise(tiny, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        GenerationEngine(tiny, max_seqs=2, max_seq_len=64, block_size=16,
                         **kwargs)


@pytest.mark.parametrize("name,value", [
    ("serve_spec_tokens", 2), ("serve_prefix_cache", True),
    ("serve_kv_host_tier", True)])
def test_unported_flags_raise(tiny, name, value):
    old = flags.flag(name)
    flags.set_flags({name: value})
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            GenerationEngine(tiny, max_seqs=2, max_seq_len=64,
                             block_size=16)
    finally:
        flags.set_flags({name: old})


def test_unported_models_raise():
    """recompute and a sequence-parallel hybrid are not ported; a
    sequence-parallel Llama is (``test_sep_llama_at_sp1_equals_plain``)."""
    from paddle_tpu_torch.models import HybridSSMForCausalLM, ssm_tiny_config
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.3"):
        LlamaForCausalLM(llama_tiny_config(recompute=True), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.9 and A.10"):
        HybridSSMForCausalLM(ssm_tiny_config(sequence_parallel=True),
                             device="cpu")

    class NotALlama(torch.nn.Module):
        config = llama_tiny_config()

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        GenerationEngine(NotALlama())


def test_training_modules_load_no_jax():
    """The training slice's modules (optimizer, jit, the fused block,
    the backward kernels' wrappers) import torch and nothing of JAX."""
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.ops.kernels.fused_block, "
            "paddle_tpu_torch.incubate.nn.functional; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"paddle_tpu_torch/optimizer/optimizers.py",
            "paddle_tpu_torch/jit/api.py",
            "paddle_tpu_torch/ops/kernels/fused_block.py"} <= files


def test_moe_modules_load_no_jax():
    """The MoE slice's modules (gates, MoELayer, the grouped GEMMs) import
    torch and nothing of JAX, and an MoE Llama builds in the port."""
    code = ("import sys, paddle_tpu_torch.incubate.distributed.models.moe, "
            "paddle_tpu_torch.ops.kernels.grouped_gemm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"paddle_tpu_torch/incubate/distributed/models/moe/gate.py",
            "paddle_tpu_torch/incubate/distributed/models/moe/moe_layer.py",
            "paddle_tpu_torch/ops/kernels/grouped_gemm.py"} <= files
    m = LlamaForCausalLM(llama_tiny_config(moe_num_experts=2), device="cpu")
    assert GenerationEngine(m, max_seqs=2, max_seq_len=64,
                            block_size=16).mode == "compiled"


def test_grouped_gemm_kernels_refuse_what_they_cannot_take():
    """A tensor off the CPU and off CUDA, or a dtype pair the kernels do
    not take, raises by name: no silent twin."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as pt_gg
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(2, 16, 24, device="meta")
    c = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_gg.gmm(x, w, c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_gg.tgmm(x, torch.empty(8, 24, device="meta"), c)
    with pytest.raises(ValueError, match="not taken"):
        pt_gg.gmm2(x.bfloat16(), w, w, c)


def test_fused_block_kernel_refuses_what_it_cannot_take():
    """A CUDA-side limit raises by name: no silent twin."""
    from paddle_tpu_torch.ops.kernels import fused_block as pt_fb
    meta = [torch.empty(s, device="meta") for s in
            ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 64), (64,),
             (64, 64), (64, 96), (64, 96), (96, 64))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_fb.fused_block(*meta)


def test_unported_optimizer_options_raise():
    from paddle_tpu_torch.optimizer import AdamW
    p = [torch.nn.Parameter(torch.zeros(3))]
    for kw in (dict(multi_precision=True), dict(grad_clip=object()),
               dict(learning_rate=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            AdamW(parameters=p, **kw)


def test_ssm_and_eager_modules_load_no_jax():
    """The hybrid slice's modules (the SSM model, the scan and paged
    decode wrappers, the engine) import torch and nothing of JAX, and a
    hybrid model serves in both modes on the CPU."""
    code = ("import sys, paddle_tpu_torch.models.ssm, "
            "paddle_tpu_torch.ops.kernels.selective_scan, "
            "paddle_tpu_torch.ops.kernels.paged_attention, "
            "paddle_tpu_torch.inference.engine; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"paddle_tpu_torch/models/ssm.py",
            "paddle_tpu_torch/ops/kernels/selective_scan.py",
            "paddle_tpu_torch/ops/kernels/paged_attention.py"} <= files
    from paddle_tpu_torch.models import HybridSSMForCausalLM, ssm_tiny_config
    m = HybridSSMForCausalLM(ssm_tiny_config(), device="cpu")
    for mode in ("auto", "eager"):
        eng = GenerationEngine(m, max_seqs=2, max_seq_len=64, block_size=16,
                               mode=mode)
        assert eng.is_hybrid and eng.mode == mode.replace("auto",
                                                          "compiled")


def test_scan_and_paged_kernels_refuse_what_they_cannot_take():
    """Off the CPU and off CUDA, with a query or an input that needs
    gradients, or at a shape the kernels do not take, the wrappers raise
    by name: no silent twin."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pt_pa
    from paddle_tpu_torch.ops.kernels import selective_scan as pt_ss
    meta = dict(device="meta")
    q = torch.empty(2, 8, 128, **meta)
    kc = torch.empty(64, 2, 128, **meta)
    tables = torch.empty(2, 4, dtype=torch.int32, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_pa.paged_decode_attention(q, kc, kc, tables, lens, 16)
    with pytest.raises(ValueError, match="no backward"):
        pt_pa.paged_decode_attention(q.requires_grad_(True), kc, kc, tables,
                                     lens, 16)
    assert not pt_pa.eligible((2, 8, 96), 2, 96)
    x = torch.empty(1, 40, 4, 16, **meta)
    dt = torch.empty(1, 40, 4, **meta)
    a = torch.empty(4, **meta)
    b = torch.empty(1, 40, 16, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_ss.selective_scan(x, dt, a, b, b)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.9"):
        pt_ss.selective_scan(x.requires_grad_(True), dt, a, b, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_ss.scan_chunked(torch.empty(1, 48, 4, 12, **meta),
                           torch.empty(1, 4, 48, **meta), b, b, 16)
    assert "multiples of 8" in pt_ss.ineligible_reason((1, 48, 4, 12), 16,
                                                       16, torch.float32)


def _sep_pair(**cfg):
    """A plain tiny Llama and a ``sequence_parallel`` one with the same
    weights, on the CPU."""
    plain = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu", seed=3)
    sep = LlamaForCausalLM(llama_tiny_config(sequence_parallel=True, **cfg),
                           device="cpu", seed=3)
    sep.load_state_dict(plain.state_dict())
    return plain, sep


def test_sep_llama_at_sp1_equals_plain():
    """``sequence_parallel=True`` without a mesh, and on a mesh whose sep
    axis has one rank, runs plain attention: loss and gradients equal the
    plain model's bit for bit."""
    import paddle_tpu_torch.distributed as dist
    plain, sep = _sep_pair(num_hidden_layers=2)
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    want, _ = plain(ids, labels=ids)
    want.backward()
    for mesh in (None, dist.ProcessMesh([[0]], ["dp", "sep"])):
        dist.set_mesh(mesh)
        try:
            got, _ = sep(ids, labels=ids)
            got.backward()
        finally:
            dist.set_mesh(None)
        assert torch.equal(got, want)
        for a, b in zip(sep.parameters(), plain.parameters()):
            assert torch.equal(a.grad, b.grad)
        sep.zero_grad(set_to_none=True)


def test_fused_block_refuses_sequence_parallel_layers(recwarn):
    """A sequence-parallel layer never takes the fused block: its
    attention would skip the ring. With ``pallas_fused_block=on`` it
    composes (as ``off`` does), with one warning naming the reason."""
    from paddle_tpu_torch.models import llama as pt_llama
    plain, sep = _sep_pair(num_hidden_layers=1)
    h = torch.randn(1, 8, 64, generator=torch.Generator().manual_seed(1))
    layer, plain_layer = sep.llama.layers[0], plain.llama.layers[0]
    old = flags.flag("pallas_fused_block")
    pt_llama._warned_fused.discard("sequence-parallel attention runs over "
                                   "the mesh")
    try:
        flags.set_flags({"pallas_fused_block": "on"})
        assert layer._fused_forward(h) is None
        assert plain_layer._fused_forward(h) is not None
        got = layer(h)
        flags.set_flags({"pallas_fused_block": "off"})
        want = plain_layer(h)
    finally:
        flags.set_flags({"pallas_fused_block": old})
    assert torch.equal(got, want)
    msgs = [str(w.message) for w in recwarn.list]
    assert sum("sequence-parallel attention runs over the mesh" in m
               for m in msgs) == 1, msgs


def test_distributed_modules_load_no_jax():
    """The context-parallel slice's modules (env, spawn, mesh, the
    collectives and the ring) import torch and nothing of JAX."""
    code = ("import sys, paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.distributed.sequence_parallel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"paddle_tpu_torch/distributed/env.py",
            "paddle_tpu_torch/distributed/spawn.py",
            "paddle_tpu_torch/distributed/process_mesh.py",
            "paddle_tpu_torch/distributed/collective.py",
            "paddle_tpu_torch/distributed/sequence_parallel.py"} <= files


def test_expert_parallel_modules_load_no_jax():
    """The expert-parallel slice's modules (the a2a dispatch, the exchange
    kernels' wrappers, shard_layer) import torch and nothing of JAX, and
    the exchange wrappers refuse a tensor neither on the CPU (the twins)
    nor on a card (the kernels)."""
    code = ("import sys, paddle_tpu_torch.incubate.distributed.models.moe."
            "moe_a2a, paddle_tpu_torch.ops.kernels.async_collectives, "
            "paddle_tpu_torch.distributed.api; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"paddle_tpu_torch/incubate/distributed/models/moe/moe_a2a.py",
            "paddle_tpu_torch/ops/kernels/async_collectives.py",
            "paddle_tpu_torch/distributed/api.py"} <= files
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    meta = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        hops.tiled_a2a(meta)
    counts = torch.empty(2, dtype=torch.int32, device="meta")
    w = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        hops.fused_a2a_expert_mlp(meta, counts, counts, w, w,
                                  torch.empty(2, 8, 4, device="meta"),
                                  group=None, chunks=1, bucket=8, c_pad=64)


FLEET_MODULES = (
    "paddle_tpu_torch.inference.server", "paddle_tpu_torch.inference.router",
    "paddle_tpu_torch.inference.fleet",
    "paddle_tpu_torch.inference.kv_handoff",
    "paddle_tpu_torch.distributed.launch.master",
    "paddle_tpu_torch.distributed.launch.serve_host",
    "paddle_tpu_torch.ops.kernels.kv_handoff",
    "paddle_tpu_torch.observability.tracing",
    "paddle_tpu_torch.observability.ops",
    "paddle_tpu_torch.testing.fault_injection")


def test_fleet_modules_load_no_jax():
    """The serving fleet's modules (server, router, fleet, handoff, master,
    the host process, #18's wrapper, tracing, the ops seam, the chaos
    hooks) import torch and nothing of JAX."""
    code = ("import sys, " + ", ".join(FLEET_MODULES) + "; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {m.replace(".", "/") + ".py" for m in FLEET_MODULES} <= files


def test_a_spawned_serve_host_loads_no_jax():
    """A host process built from a spec (on the CPU, as the spec asks),
    serve-registered and serving, has imported nothing of JAX."""
    spec = ('{"model": "llama_tiny", "seed": 7, "device": "cpu", '
            '"engine": {"max_seqs": 2, "max_seq_len": 64, "block_size": 16}}')
    code = (
        "import json, os, sys, threading, time\n"
        "from paddle_tpu_torch.distributed.launch import serve_host\n"
        "from paddle_tpu_torch.distributed.launch.master import "
        "HTTPMaster, MasterClient\n"
        "m = HTTPMaster()\n"
        "threading.Thread(target=serve_host.main, args=(['--name', 'h0', "
        "'--role', 'decode', '--master', m.address, '--spec', "
        f"{spec!r}],), daemon=True).start()\n"
        "end = time.time() + 90\n"
        "while 'h0' not in MasterClient(m.address, 'p').serve_fleet()"
        "['hosts']:\n"
        "    assert time.time() < end\n"
        "    time.sleep(0.05)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "print(bad, flush=True)\n"
        "os._exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr


def test_fleet_entry_points_default_to_cuda(monkeypatch):
    """A host spec without a ``"device"`` builds on the card, and raises
    without one; the device-to-device handoff is off for a CPU engine."""
    from paddle_tpu_torch.distributed.launch import serve_host
    from paddle_tpu_torch.inference import kv_handoff
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_host.build_from_spec({"model": "llama_tiny", "seed": 0})
    _, eng, srv = serve_host.build_from_spec(
        {"model": "llama_tiny", "seed": 0, "device": "cpu",
         "engine": {"max_seqs": 2, "max_seq_len": 64, "block_size": 16}})
    assert eng.cache.device == torch.device("cpu")
    assert not kv_handoff.dma_handoff_enabled(eng)
    srv.close()


def test_remote_copy_kernel_refuses_what_it_cannot_take():
    """#18's wrapper and its pull refuse a tensor neither on the CPU (the
    twin) nor on a card (the kernel)."""
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    meta = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        k18.kv_pages_remote_copy(meta, 0, 1)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        k18.pages_copy(meta, 0)
