"""The port's selective scan
(``paddle_tpu_torch/ops/kernels/selective_scan.py``) against the JAX
package's (``paddle_tpu/ops/pallas/selective_scan.py``).

Inputs are made with numpy from seeds. The JAX chunked scan runs its Pallas
kernel in interpret mode (``pallas_selective_scan=on``), as
``tests/test_ssm.py`` runs it; on the CPU the port runs the kernel's
chunked twin. Tolerances follow ``tests/op_harness.py``: fp32 rtol 1e-5 /
atol 1e-6 (a state or an output is a sum of a chunk's and the carry's
terms, taken in another order: atol 1e-6 times the tensor's largest
magnitude where stated), bf16 2e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import flags as jax_flags
from paddle_tpu.ops.pallas import selective_scan as jss
from paddle_tpu.ops.pallas.autotune import resolve_selective_scan_chunk
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch.ops.kernels import selective_scan as pss

FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _jax_chunked_scan():
    """The JAX scan through its Pallas kernel (interpreted on the CPU)."""
    old = jax_flags.flag("pallas_selective_scan")
    jax_flags.set_flags({"pallas_selective_scan": "on"})
    yield
    jax_flags.set_flags({"pallas_selective_scan": old})
    jss.reset_scan_path_counts()


def _inputs(b=2, l=64, h=4, dh=16, ds=16, dtype=np.float32, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, l, h, dh).astype(np.float32)
    dt = (np.abs(rs.randn(b, l, h)) * 0.1 + 0.01).astype(np.float32)
    A = (-np.abs(rs.randn(h)) - 0.1).astype(np.float32)
    B = rs.randn(b, l, ds).astype(np.float32)
    C = rs.randn(b, l, ds).astype(np.float32)
    return x, dt, A, B, C


def _jax(arrs, dtype):
    x, dt, A, B, C = arrs
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(B, jd), jnp.asarray(C, jd))


def _torch(arrs, dtype):
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrs)
    td = getattr(torch, dtype)
    return x.to(td), dt, A, B.to(td), C.to(td)


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _close(got, want, tol, scaled=False):
    want = _f64(want)
    atol = tol["atol"] * (np.abs(want).max() if scaled else 1.0)
    np.testing.assert_allclose(_f64(got), want, rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("l,chunk", [(64, 16), (50, 16), (17, 16), (1, 16),
                                     (100, 32)])
def test_chunked_twin_matches_jax_kernel_fp32(l, chunk):
    """y and the final state, for lengths that are and are not multiples
    of the chunk (the padded tail must leave the state after l-1)."""
    arrs = _inputs(l=l, seed=l)
    yj, sj = jss.selective_scan(*_jax(arrs, "float32"), chunk=chunk)
    yp, sp = pss.selective_scan(*_torch(arrs, "float32"), chunk=chunk)
    assert yp.shape == arrs[0].shape and sp.shape == (2, 4, 16, 16)
    assert yp.dtype == torch.float32 and sp.dtype == torch.float32
    _close(yp, yj, FP32, scaled=True)
    _close(sp, sj, FP32, scaled=True)


def test_chunked_twin_matches_jax_kernel_bf16():
    """bf16 x, B and C: y in bf16, the state fp32; the decay matrix is
    rounded to bf16 at the same chunk on both sides."""
    arrs = _inputs(l=48, seed=2)
    yj, sj = jss.selective_scan(*_jax(arrs, "bfloat16"), chunk=16)
    yp, sp = pss.selective_scan(*_torch(arrs, "bfloat16"), chunk=16)
    assert yp.dtype == torch.bfloat16 and sp.dtype == torch.float32
    _close(yp, yj, BF16)
    _close(sp, sj, BF16)


def test_scan_reference_matches_jax_reference_on_padded_inputs():
    """The twin itself (``_scan_reference``) on the reference's padded
    operands against the JAX composed reference (``_scan_reference``)."""
    x, dt, A, B, C = _inputs(l=32, seed=3)
    la = dt * A
    dtx = dt[..., None] * x
    la_t = np.ascontiguousarray(la.transpose(0, 2, 1))
    cfg = (2, 32, 4, 16, 16, 2, 16)
    yj, sj = jss._scan_reference(*map(jnp.asarray, (dtx, la_t, B, C)), cfg)
    yp, sp = pss._scan_reference(*map(torch.from_numpy, (dtx, la_t, B, C)),
                                 16)
    _close(yp, yj, FP32, scaled=True)
    _close(sp, sj, FP32, scaled=True)


def test_associative_path_matches_xla_selective_scan():
    arrs = _inputs(l=37, seed=4)
    yj, sj = jss.xla_selective_scan(*_jax(arrs, "float32"))
    yp, sp = pss.xla_selective_scan(*_torch(arrs, "float32"))
    _close(yp, yj, FP32, scaled=True)
    _close(sp, sj, FP32, scaled=True)


def test_flag_off_takes_the_associative_path():
    """``pallas_selective_scan=off`` is the associative scan on CPU tensors
    and raises on any other device, where that path has no kernel; ``auto``
    is the chunked form. The two agree to the fp32 tier."""
    arrs = _torch(_inputs(l=40, seed=5), "float32")
    old = pt_flags.flag("pallas_selective_scan")
    try:
        pt_flags.set_flags({"pallas_selective_scan": "off"})
        y_off, s_off = pss.selective_scan(*arrs)
        with pytest.raises(NotImplementedError, match="no kernel"):
            pss.selective_scan(*[a.to("meta") for a in arrs])
        pt_flags.set_flags({"pallas_selective_scan": "auto"})
        y_auto, s_auto = pss.selective_scan(*arrs)
        pt_flags.set_flags({"pallas_selective_scan": "sometimes"})
        with pytest.raises(ValueError, match="pallas_selective_scan"):
            pss.selective_scan(*arrs)
    finally:
        pt_flags.set_flags({"pallas_selective_scan": old})
    assert torch.equal(y_off, pss.xla_selective_scan(*arrs)[0])
    _close(y_auto, y_off, FP32, scaled=True)
    _close(s_auto, s_off, FP32, scaled=True)


def test_update_continues_the_scan():
    """Stepping ``selective_scan_update`` through the sequence from a zero
    state gives the full scan's outputs and final state, on both sides,
    and the two steps agree."""
    arrs = _inputs(l=24, seed=7)
    x, dt, A, B, C = _torch(arrs, "float32")
    jx, jdt, jA, jB, jC = _jax(arrs, "float32")
    y_ref, s_ref = pss.selective_scan(x, dt, A, B, C, chunk=16)
    st = torch.zeros(2, 4, 16, 16)
    jst = jnp.zeros((2, 4, 16, 16), jnp.float32)
    ys = []
    for t in range(24):
        y_t, st = pss.selective_scan_update(st, x[:, t], dt[:, t], A,
                                            B[:, t], C[:, t])
        jy_t, jst = jss.selective_scan_update(jst, jx[:, t], jdt[:, t], jA,
                                              jB[:, t], jC[:, t])
        _close(y_t, jy_t, FP32, scaled=True)
        ys.append(y_t)
    _close(st, jst, FP32, scaled=True)
    _close(torch.stack(ys, dim=1), y_ref, dict(rtol=1e-4, atol=1e-5),
           scaled=True)
    _close(st, s_ref, dict(rtol=1e-4, atol=1e-5), scaled=True)


@pytest.mark.parametrize("l", [1, 5, 16, 17, 100, 128, 1023, 2047, 2048,
                               5000])
def test_chunk_resolver_matches_autotune_static_default(l):
    assert pss.resolve_chunk(l) == resolve_selective_scan_chunk(
        2, l, 4, 64, 64, jnp.float32)
    assert pss.ineligible_reason((2, l, 4, 64), 64, pss.resolve_chunk(l),
                                 torch.bfloat16) is None


def test_twin_stays_differentiable_on_the_cpu():
    """The chunked twin's gradients agree with the associative path's
    (the reference's gradient parity between its two scans)."""
    arrs = _torch(_inputs(l=32, seed=8), "float32")

    def grads(fn):
        ins = [a.clone().requires_grad_(True) for a in arrs]
        y, s = fn(*ins)
        (y.square().sum() + s.square().sum()).backward()
        return [a.grad for a in ins]

    g_c = grads(lambda *a: pss.selective_scan(*a, chunk=16))
    g_a = grads(pss.xla_selective_scan)
    for a, b in zip(g_c, g_a):
        _close(a, b, dict(rtol=1e-4, atol=1e-5), scaled=True)


@pytest.mark.parametrize("shape,ds,chunk,dtype,match", [
    ((1, 64, 4, 12), 16, 16, torch.float32, "multiples of 8"),
    ((1, 64, 4, 16), 16, 24, torch.float32, "chunk 24"),
    ((1, 64, 4, 16), 16, 512, torch.float32, "chunk 512"),
    ((1, 64, 4, 16), 16, 16, torch.float16, "dtype"),
    ((1, 2048, 4, 256), 256, 256, torch.float32, "shared memory")])
def test_ineligible_reasons(shape, ds, chunk, dtype, match):
    assert match in pss.ineligible_reason(shape, ds, chunk, dtype)
