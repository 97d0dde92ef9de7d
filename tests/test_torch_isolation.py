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
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch.inference, paddle_tpu_torch.models,"
            " paddle_tpu_torch.weights, paddle_tpu_torch.ops.kernels; "
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
    dict(mode="eager"), dict(spec_tokens=2), dict(prefix_cache=True),
    dict(kv_quant="int8"), dict(weight_quant=True), dict(host_tier=True)])
def test_unported_engine_options_raise(tiny, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        GenerationEngine(tiny, max_seqs=2, max_seq_len=64, block_size=16,
                         **kwargs)


@pytest.mark.parametrize("name,value", [
    ("serve_spec_tokens", 2), ("serve_prefix_cache", True),
    ("serve_kv_quant", "fp8"), ("serve_weight_quant", True),
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
    for cfg in (llama_tiny_config(moe_num_experts=2),
                llama_tiny_config(sequence_parallel=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            LlamaForCausalLM(cfg, device="cpu")

    class NotALlama(torch.nn.Module):
        config = llama_tiny_config()

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        GenerationEngine(NotALlama())
