"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

These tests need a card and skip without one (the kernels have no CPU
mode). The file imports only torch and the port, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances follow ``tests/op_harness.py`` (fp32 rtol 1e-5 / atol 1e-6,
bf16 2e-2); the log-sum-exp is held at atol 1e-5 because it adds a log
of an fp32 row sum taken in another order. fp32 matmuls in the twins run
without TF32.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as pt_flash
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as pt_ragged
from paddle_tpu_torch.ops.kernels import rms_norm as pt_rms

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return x.detach().float().cpu().numpy().astype(np.float64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ragged_inputs(dev, q_dtype, kv_dtype, d=128, kv=2, hq=4, num_blocks=16,
                   bs=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    kc = torch.randn(num_blocks * bs, kv, d, generator=g)
    vc = torch.randn(num_blocks * bs, kv, d, generator=g)
    tables = torch.randperm(num_blocks, generator=g)[:12].reshape(3, 4)
    rows = torch.tensor([0, 1, 1, 1, 1, 2, 0])
    valids = torch.tensor([13, 3, 4, 5, 6, 25, 0])
    q = torch.randn(len(rows), hq, d, generator=g)
    kvt, qt = getattr(torch, kv_dtype), getattr(torch, q_dtype)
    return [q.to(dev, qt), kc.to(dev, kvt), vc.to(dev, kvt),
            tables.to(dev, torch.int32), rows.to(dev, torch.int32),
            valids.to(dev, torch.int32), bs]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_ragged_kernel_matches_twin(cuda_device, q_dtype, kv_dtype):
    args = _ragged_inputs(cuda_device, q_dtype, kv_dtype)
    out = pt_ragged.ragged_paged_attention(*args)
    ref = pt_ragged.ragged_paged_attention_plain(*args)
    torch.cuda.synchronize()
    tol = FP32 if q_dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    assert float(out[-1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_twin(cuda_device, dtype, causal):
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, s, h, 128).astype(np.float32))
               .to(cuda_device, getattr(torch, dtype))
               for s, h in ((100, 4), (130, 2), (130, 2)))
    o, lse = pt_flash.flash_attention_with_lse(q, k, v, causal)
    ro, rlse = pt_flash.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(o), _np(ro), **tol)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_matches_twin(cuda_device, dtype):
    x = torch.randn(33, 200, device=cuda_device).to(getattr(torch, dtype))
    w = torch.rand(200, device=cuda_device) + 0.5
    out = pt_rms.rms_norm(x, w)
    ref = pt_rms.rms_norm_plain(x, w)
    torch.cuda.synchronize()
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
