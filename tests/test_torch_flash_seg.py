"""The segment-causal flash twins (#3 forward, #4 backward) against the
JAX Pallas kernels.

``flash_attention_seg_plain`` and ``flash_attention_seg_bwd_plain`` are
held against ``paddle_tpu.ops.pallas.flash_attention.
flash_attention_seg_with_lse`` and its ``jax.vjp`` (``_bwd_grouped_seg``
fed the forward's own lse), run as the JAX tests run them on the CPU
(Pallas interpret mode), on the same numpy inputs: every descriptor the
zig-zag ring issues at sp 2 and 4 (``_zigzag_seg(rank, src)``), splits
that no tile size divides, and GQA 4:2. Tolerance: the fp32 tier of
``tests/op_harness.py`` (rtol 1e-5, atol 1e-6). The CUDA kernels are held
against these twins on a card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_flash
from paddle_tpu_torch.distributed.sequence_parallel import _zigzag_seg
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as pt_flash

FP32 = dict(rtol=1e-5, atol=1e-6)
B, HQ, HK, D = 1, 4, 2, 16


def _inputs(sq, sk, seed, hq=HQ, hk=HK, d=D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, sq, hq, d).astype(np.float32)
    k = rng.randn(B, sk, hk, d).astype(np.float32)
    v = rng.randn(B, sk, hk, d).astype(np.float32)
    do = rng.randn(B, sq, hq, d).astype(np.float32)
    return q, k, v, do


def _jax_seg(q, k, v, do, seg):
    """The JAX kernel's (o, lse) and its vjp's (dq, dk, dv) for the
    cotangent ``do`` of o."""
    seg = jnp.asarray(seg, jnp.int32)
    (o, lse), vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention_seg_with_lse(a, b, c,
                                                               seg),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return [np.asarray(x) for x in (o, lse, *grads)]


def _torch_seg(q, k, v, do, seg):
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = pt_flash.flash_attention_seg_with_lse(qt, kt, vt, seg)
    grads = pt_flash.flash_attention_seg_bwd(qt, kt, vt, o, lse, dot, seg)
    return [x.numpy() for x in (o, lse, *grads)]


def _descriptors():
    """Every (sp, rank, src) step of the zig-zag ring at sp 2 and 4 over
    a global sequence of 64: local length 64/sp, chunk 32/sp."""
    for sp in (2, 4):
        c = 64 // (2 * sp)
        for idx in range(sp):
            for src in range(sp):
                yield pytest.param(2 * c, 2 * c, _zigzag_seg(idx, src, c, sp),
                                   id=f"sp{sp}-rank{idx}-src{src}")


# splits that no tile divides, a query window that straddles the key
# window's split, and windows of different lengths
ODD = [pytest.param(24, 24, [0, 30, 10, 0, 30, 10], id="straddle-self"),
       pytest.param(24, 20, [5, 40, 13, 0, 33, 7], id="straddle-cross"),
       pytest.param(20, 28, [50, 70, 9, 0, 60, 11], id="later-window")]


@pytest.mark.parametrize("sq,sk,seg", list(_descriptors()) + ODD)
def test_seg_twins_match_jax_kernels(sq, sk, seg):
    q, k, v, do = _inputs(sq, sk, seed=sum(seg) + sq)
    want = _jax_seg(q, k, v, do, seg)
    before = kernels.launch_counts()
    got = _torch_seg(q, k, v, do, seg)
    after = kernels.launch_counts()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **FP32)
    # the CPU path is the twin: no kernel launch is counted
    assert after == before


def test_seg_rows_with_nothing_visible():
    """Rows that see no column give o = 0 and lse = -inf, and no
    gradient, in the twin as in the JAX kernel."""
    q, k, v, do = _inputs(16, 16, seed=3)
    seg = [0, 8, 8, 4, 100, 16]      # rows at 0..3 precede every column
    want = _jax_seg(q, k, v, do, seg)
    got = _torch_seg(q, k, v, do, seg)
    assert np.isneginf(got[1][:, :, :4]).all()
    assert (got[0][:, :4] == 0).all() and (got[2][:, :4] == 0).all()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FP32)


@pytest.mark.parametrize("seg", [[0, 4, 8, 0, 16, 8], [0, 16, 17, 0, 16, 8],
                                 [0, 16, 8, -1, 16, 8], [0, 16, 8]])
def test_seg_descriptor_contract(seg):
    """The maps must be monotone (off1 >= off0 + split) with the split
    inside the window: the kernels' dead-tile skips rely on it."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(16, 16, seed=0))
    with pytest.raises(ValueError, match="seg"):
        pt_flash.flash_attention_seg_with_lse(q, k, v, seg)


def test_seg_wrappers_refuse_off_cuda():
    """A tensor off the CPU and off CUDA raises by name: no twin."""
    meta = [torch.empty(s, device="meta") for s in
            ((1, 16, 4, 64), (1, 16, 2, 64), (1, 16, 2, 64))]
    seg = [0, 8, 8, 0, 8, 8]
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_flash.flash_attention_seg_with_lse(*meta, seg)
    lse = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_flash.flash_attention_seg_bwd(*meta, meta[0], lse, meta[0], seg)


@pytest.mark.parametrize("idx,src", [(0, 1), (1, 0)])
def test_seg_backward_with_whole_dead_tiles_matches_jax(idx, src):
    """The t > 0 steps of sp 2 over chunks of 96 rows, head dim 64, GQA
    2:1: rank 0's first query chunk precedes every resident key, and rank
    1's second key chunk follows every query, so whole 64-row query and
    key tiles see nothing. dq there (rows with lse -inf) and dk/dv there
    (keys no row sees) are exact zeros, as in the JAX kernels (interpret
    mode), and the rest matches them at the fp32 tier."""
    c, sp = 96, 2
    seg = _zigzag_seg(idx, src, c, sp)
    q, k, v, do = _inputs(2 * c, 2 * c, seed=11 + idx, hq=2, hk=1, d=64)
    want = _jax_seg(q, k, v, do, seg)
    got = _torch_seg(q, k, v, do, seg)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **FP32)
    dq, dk, dv = got[2:]
    rows = np.isneginf(got[1][0, 0])
    keys = np.asarray(pt_flash.seg_positions(*seg[3:], 2 * c)) > np.asarray(
        pt_flash.seg_positions(*seg[:3], 2 * c)).max()
    dead_rows, dead_keys = (slice(0, 96), None) if idx == 0 else (
        None, slice(96, 192))
    if dead_rows:
        assert rows[dead_rows].all() and not rows[96:].any()
    else:
        assert keys[dead_keys].all() and not keys[:96].any()
    for a, b, mask in ((dq, want[2], rows), (dk, want[3], keys),
                       (dv, want[4], keys)):
        assert (a[:, mask] == 0).all() and (b[:, mask] == 0).all()
        assert np.abs(a[:, ~mask]).max() > 0


def test_seg_backward_routes_by_alignment():
    """A bf16 segment backward takes #2's ``wgmma`` kernels where TMA can
    map q, k, v, o and dO (16-byte-aligned bases) and the grids' batch x
    heads fit 65535, else the CUDA-core kernels: decided from shapes and
    pointers alone, before any launch."""
    q = torch.zeros(1, 64, 16, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 64, 8, 64, dtype=torch.bfloat16)
    assert pt_flash._seg_bwd_tma_ok(1, 16, 8, q, kv, kv, q, q)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    off = flat[1:].view(q.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert not pt_flash._seg_bwd_tma_ok(1, 16, 8, q, kv, kv, off, q)
    assert not pt_flash._seg_bwd_tma_ok(4096, 16, 8, q, kv, kv, q, q)
