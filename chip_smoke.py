#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: Python, torch and CUDA versions, the card's name and power
   limit (``nvidia-smi``);
2. build: every kernel under ``paddle_tpu_torch/csrc`` compiled by nvcc
   from this checkout;
3. kernels: each kernel's wrapper on CUDA tensors at the shapes its path
   gives it (serving at Llama-3-8B widths: head_dim 128, 32:8 heads,
   hidden 4096; training at the flagship widths: 4 x 2048 tokens, hidden
   1536, ffn 4096, 12:4 heads, where the flash and RMSNorm forwards are
   checked too) held against its plain PyTorch twin on the same inputs
   (each backward kernel also twice, bitwise), then timed
   beside the twin, the PyTorch library call that computes the same
   function (where one exists) and the least time the card could take;
4. serve, the slice-1 path, with ``pallas_fused_block=off``:
   ``GenerationEngine.generate`` serving 8 requests (prompts of 32..1024
   tokens, 32 new tokens each, 6 greedy and 2 sampled) on a
   Llama-3-8B-width model with seeded random weights, then
   ``LlamaForCausalLM.forward`` scoring the prompts. Kernel launch counts
   are zeroed just before and read just after. Checks: finish reasons, no
   page leak, ragged launches == steps x layers, a second run bitwise
   equal (run under ``torch.profiler`` for a device-time breakdown),
   greedy tokens >= 99% equal to the same engine with the plain attention
   twin, one decoder layer through the kernels equal to its plain-twin
   run at the bf16 tier, and the kernel forward no further from an fp32
   reference forward than the plain-twin forward is;
5. train, the slice-2 path: ``bench.py:_llama_run`` at the flagship
   configuration (vocab 32000, hidden 1536, ffn 4096, 12 layers, GQA
   12:4, seq 2048, batch 4, bf16, ~400M parameters, seeded random
   weights, ``pallas_fused_block=auto``): AdamW(lr 1e-4, wd 0.1), the
   step ``loss, _ = model(ids, labels=ids); loss.backward(); opt.step();
   opt.clear_grad()`` under ``jit.to_static`` on one fixed batch, 2+1
   warmup steps then 10 timed steps, as the bench times (counts zeroed
   just before, read just after). Reports tokens/s, ms per step, MFU
   (the bench's formula against 989 TFLOP/s bf16) and, from a profiled
   repeat, the device's busy share and top kernels. Checks: finite,
   falling losses; per step 12 launches each of the fused block, flash
   forward and flash backward and 25 of each RMSNorm kernel; one step's
   loss and gradients through
   the kernels against the plain twins and an fp32 copy, over all
   parameters and per parameter; a second run from the seed bitwise
   equal;
6. the ``kernels`` JSON line, then the result line.

fp32 matmuls run without TF32 throughout (``allow_tf32 = False``), so the
twins and the serving step's fp32 projections are full fp32.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# bytes/s and flop/s of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def log(*args):
    print(*args, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
class Timer:
    """Kernel time from CUDA events, one launch at a time with the L2
    cache (50 MB) flushed in between, so every launch reads cold inputs as
    the serving step's first touch of a layer's pages does."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters=10, warmup=2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def scaled_close(got, want, rtol, atol) -> bool:
    """``|got - want| <= atol * max|want| + rtol * |want|``: for tensors
    whose elements are long sums, an element is off by the rounding of its
    terms, whose size is the tensor's scale and not the element's."""
    g, w = got.float(), want.float()
    tol = atol * float(w.abs().max()) + rtol * w.abs()
    return bool(((g - w).abs() <= tol).all())


# --------------------------------------------------------- kernel phases
def phase_ragged(torch, timer, rng):
    """fp32 q [72, 32, 128] over bf16 pages of 64-token blocks, as the
    compiled step feeds it: 7 decode rows, one 64-token prompt chunk and a
    pad row."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rp
    hq, hkv, d, bs, seqs, width = 32, 8, 128, 64, 8, 32
    nblocks = seqs * width
    perm = torch.from_numpy(rng.permutation(nblocks).astype("int32"))
    tables = perm.reshape(seqs, width).cuda()
    kc = torch.randn(nblocks * bs, hkv, d, device="cuda").bfloat16()
    vc = torch.randn(nblocks * bs, hkv, d, device="cuda").bfloat16()
    lens = [130, 257, 385, 512, 640, 771, 1000]        # decode rows
    rows = list(range(7)) + [7] * 64 + [0]
    valids = lens + list(range(449, 513)) + [0]        # chunk at 448..511
    t = len(rows)
    q = torch.randn(t, hq, d, device="cuda")
    r = torch.tensor(rows, dtype=torch.int32, device="cuda")
    v = torch.tensor(valids, dtype=torch.int32, device="cuda")
    args = (q, kc, vc, tables, r, v, bs)
    out = rp.ragged_paged_attention(*args)
    ref = rp.ragged_paged_attention_plain(*args)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 2e-5   # fp32 sums over up to 1000 keys in another order
    assert err <= tol, f"ragged: max_abs_err {err} > {tol}"
    assert float(out[-1].abs().max()) == 0.0, "ragged: pad row is not 0"
    # bytes: each visible page once (the chunk's tokens share theirs),
    # q read once, out written once; flops: 4*d per (query head, key)
    blocks = {(row, j) for row, val in zip(rows, valids)
              for j in range(-(-val // bs))}
    page = bs * hkv * d * 2 * 2
    nbytes = len(blocks) * page + q.numel() * 4 * 2 + t * 8
    flops = sum(valids) * hq * 4 * d
    b_ms, b_by = bound(nbytes, flops, "fp32")
    return dict(name="ragged_paged_attention", route="cuda",
                source="paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                replaces="paddle_tpu/ops/pallas/ragged_paged_attention.py:105",
                path="serve", max_abs_err=err, tolerance=tol,
                ms=timer.ms(lambda: rp.ragged_paged_attention(*args)),
                plain_ms=timer.ms(lambda: rp.ragged_paged_attention_plain(
                    *args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"q fp32 [{t}, {hq}, {d}], bf16 pages, block 64")


def _sdpa_lib(torch, q, k, v):
    """``scaled_dot_product_attention`` on [b, h, s, d] views of the
    port's [b, s, h, d] tensors, causal, GQA (k/v repeated outside the
    call on a torch without ``enable_gqa``)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt[:, :, :1], kt[:, :, :1],
                                       vt[:, :, :1], is_causal=True,
                                       enable_gqa=True)
        return lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True, enable_gqa=True), (qt, kt, vt)
    except TypeError:
        g = q.shape[2] // k.shape[2]
        kr, vr = (x.repeat_interleave(g, dim=1) for x in (kt, vt))
        return lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True), (qt, kr, vr)


def phase_flash(torch, timer):
    """Causal bf16 [1, 2048, 32|8, 128], and a ragged length (1000)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    res = None
    for s in (1000, 2048):
        q = torch.randn(1, s, 32, 128, device="cuda").bfloat16()
        k = torch.randn(1, s, 8, 128, device="cuda").bfloat16()
        v = torch.randn(1, s, 8, 128, device="cuda").bfloat16()
        o, lse = fa.flash_attention_with_lse(q, k, v, True)
        ro, rlse = fa.flash_attention_plain(q, k, v, True)
        torch.cuda.synchronize()
        err, lerr = max_err(o, ro), max_err(lse, rlse)
        # bf16 output: p is rounded to bf16 against a running max in the
        # kernel and against the row max in the twin
        tol = 2e-2
        assert err <= tol and lerr <= 1e-4, \
            f"flash s={s}: max_abs_err {err} (lse {lerr})"
        log(f"flash s={s}: max_abs_err {err:.3g}, lse err {lerr:.3g}")
        if res is None:
            res = err
    fn, lib_args = _sdpa_lib(torch, q, k, v)
    pairs = s * (s + 1) // 2
    flops = 4 * 32 * 128 * pairs
    nbytes = (q.numel() * 2 + k.numel() * 2 * 2 + q.numel() * 2 + 32 * s * 4)
    b_ms, b_by = bound(nbytes, flops, "bf16")
    return dict(name="flash_attention_fwd", route="cuda",
                source="paddle_tpu_torch/csrc/flash_attention.cu",
                replaces="paddle_tpu/ops/pallas/flash_attention.py:130",
                path="serve", max_abs_err=max(res, err), tolerance=tol,
                ms=timer.ms(lambda: fa.flash_attention_with_lse(q, k, v,
                                                                True)),
                plain_ms=timer.ms(lambda: fa.flash_attention_plain(q, k, v,
                                                                   True)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timer.ms(lambda: fn(*lib_args)),
                shape="causal bf16 q [1, 2048, 32, 128], k/v [1, 2048, 8, 128]")


def phase_rms(torch, timer):
    """[2048, 4096] bf16 x with an fp32 weight."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    x = torch.randn(2048, 4096, device="cuda").bfloat16()
    w = torch.rand(4096, device="cuda") + 0.5
    out = rn.rms_norm(x, w, 1e-5)
    ref = rn.rms_norm_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert ok, f"rms_norm: max_abs_err {err} beyond rtol/atol 2e-2"
    wb = w.bfloat16()
    lib = None
    if hasattr(F, "rms_norm"):
        lib = timer.ms(lambda: F.rms_norm(x, (4096,), wb, 1e-5))
    nbytes = x.numel() * 2 * 2 + w.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * x.numel(), "fp32")
    return dict(name="rms_norm_fwd", route="cuda",
                source="paddle_tpu_torch/csrc/rms_norm.cu",
                replaces="paddle_tpu/ops/pallas/rms_norm.py:64",
                path="serve", max_abs_err=err,
                tolerance="rtol=atol=2e-2 (bf16 output)",
                ms=timer.ms(lambda: rn.rms_norm(x, w, 1e-5)),
                plain_ms=timer.ms(lambda: rn.rms_norm_plain(x, w, 1e-5)),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                shape="x bf16 [2048, 4096], w fp32 [4096]")


# the training slice's shapes (bench.py:2315-2320)
TRAIN_B, TRAIN_S, TRAIN_HQ, TRAIN_HKV, TRAIN_D = 4, 2048, 12, 4, 128
TRAIN_HIDDEN, TRAIN_FFN = 1536, 4096
TRAIN_LAYERS = 12
TRAIN_STEPS = 10        # timed steps, as the bench times


def phase_flash_bwd(torch, timer):
    """The backward at the flagship's attention shape: causal bf16 q
    [4, 2048, 12, 128], k/v [4, 2048, 4, 128] (GQA 3:1). The forward
    kernel is held against its twin at this shape first, with the
    serving shape's tolerances."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    b, s, hq, hkv, d = TRAIN_B, TRAIN_S, TRAIN_HQ, TRAIN_HKV, TRAIN_D
    q = torch.randn(b, s, hq, d, device="cuda").bfloat16()
    k = torch.randn(b, s, hkv, d, device="cuda").bfloat16()
    v = torch.randn(b, s, hkv, d, device="cuda").bfloat16()
    do = torch.randn(b, s, hq, d, device="cuda").bfloat16()
    o, lse = fa.flash_attention_with_lse(q, k, v, True)
    ro, rlse = fa.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    fwd_err, lerr = max_err(o, ro), max_err(lse, rlse)
    log(f"flash fwd at the train shape: max_abs_err {fwd_err:.3g}, lse err "
        f"{lerr:.3g}")
    assert fwd_err <= 2e-2 and lerr <= 1e-4, \
        f"flash fwd train shape: max_abs_err {fwd_err} (lse {lerr})"
    del ro, rlse
    args = (q, k, v, o, lse, do, True)
    got = fa.flash_attention_bwd(*args)
    again = fa.flash_attention_bwd(*args)
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again)), \
        "flash bwd: two launches on the same inputs differ"
    # bf16 gradients, each element a sum over up to 2048 keys (dq) or
    # 3 x 2048 queries (dk, dv): bf16 tier with atol scaled by the
    # tensor's largest magnitude
    err = max(max_err(a, c) for a, c in zip(got, want))
    for name, a, c in zip(("dq", "dk", "dv"), got, want):
        ok = scaled_close(a, c, 2e-2, 2e-2)
        log(f"flash bwd {name}: max_abs_err {max_err(a, c):.4g} of max "
            f"{float(c.float().abs().max()):.4g}, rel L2 {_rel(a, c):.3g}")
        assert ok, f"flash bwd {name} beyond the bf16 tier"
    del want
    torch.cuda.empty_cache()
    fn, lib_args = _sdpa_lib(torch, q, k, v)
    lib_in = [t.detach().requires_grad_(True) for t in lib_args]
    lib_out = fn(*lib_in)
    lib_do = do.transpose(1, 2)
    pairs = b * hq * s * (s + 1) // 2
    flops = 10 * d * pairs
    nbytes = (q.numel() * 2 * 3 + k.numel() * 2 * 4 + lse.numel() * 4)
    b_ms, b_by = bound(nbytes, flops, "bf16")
    return dict(name="flash_attention_bwd", route="cuda",
                source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                replaces="paddle_tpu/ops/pallas/flash_attention.py:303",
                path="train", max_abs_err=err,
                tolerance="rtol 2e-2, atol 2e-2 x max|twin|; bitwise repeat",
                ms=timer.ms(lambda: fa.flash_attention_bwd(*args)),
                plain_ms=timer.ms(lambda: fa.flash_attention_bwd_plain(*args),
                                  iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timer.ms(lambda: torch.autograd.grad(
                    lib_out, lib_in, lib_do, retain_graph=True)),
                shape="causal bf16 q [4, 2048, 12, 128], k/v [4, 2048, 4, 128]",
                fwd_checks={"flash_attention_fwd": fwd_err})


def phase_rms_bwd(torch, timer):
    """The backward over the flagship's 8192 tokens: x and dy bf16
    [8192, 1536], w fp32. The forward kernel is held against its twin at
    this shape first."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    rows, d = TRAIN_B * TRAIN_S, TRAIN_HIDDEN
    x = torch.randn(rows, d, device="cuda").bfloat16()
    dy = torch.randn(rows, d, device="cuda").bfloat16()
    w = torch.rand(d, device="cuda") + 0.5
    y, ry = rn.rms_norm(x, w, 1e-5), rn.rms_norm_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    fwd_err = max_err(y, ry)
    log(f"rms fwd at the train shape: max_abs_err {fwd_err:.4g}")
    assert torch.allclose(y.float(), ry.float(), rtol=2e-2, atol=2e-2), \
        f"rms fwd train shape: max_abs_err {fwd_err} beyond rtol/atol 2e-2"
    del y, ry
    dx, dw = rn.rms_norm_bwd(x, w, dy, 1e-5)
    dx2, dw2 = rn.rms_norm_bwd(x, w, dy, 1e-5)
    rdx, rdw = rn.rms_norm_bwd_plain(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2), \
        "rms bwd: two launches on the same inputs differ"
    assert torch.allclose(dx.float(), rdx.float(), rtol=2e-2, atol=2e-2), \
        f"rms bwd dx: max_abs_err {max_err(dx, rdx)}"
    # dw: fp32 sums over 8192 rows in another order
    assert scaled_close(dw, rdw, 1e-4, 1e-5), \
        f"rms bwd dw: max_abs_err {max_err(dw, rdw)}"
    log(f"rms bwd: dx max_abs_err {max_err(dx, rdx):.4g}, dw max_abs_err "
        f"{max_err(dw, rdw):.4g} of max {float(rdw.abs().max()):.4g}")
    lib = None
    if hasattr(F, "rms_norm"):
        xl = x.detach().requires_grad_(True)
        wl = w.bfloat16().requires_grad_(True)
        yl = F.rms_norm(xl, (d,), wl, 1e-5)
        lib = timer.ms(lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                                   retain_graph=True))
    nbytes = x.numel() * 2 * 3 + w.numel() * 4 * 2
    b_ms, b_by = bound(nbytes, 12 * x.numel(), "fp32")
    return dict(name="rms_norm_bwd", route="cuda",
                source="paddle_tpu_torch/csrc/rms_norm.cu",
                replaces="paddle_tpu/ops/pallas/rms_norm.py:116",
                path="train", max_abs_err=max(max_err(dx, rdx),
                                              max_err(dw, rdw)),
                tolerance="dx rtol=atol=2e-2; dw rtol 1e-4, atol 1e-5 x "
                          "max|twin|; bitwise repeat",
                ms=timer.ms(lambda: rn.rms_norm_bwd(x, w, dy, 1e-5)),
                plain_ms=timer.ms(lambda: rn.rms_norm_bwd_plain(x, w, dy,
                                                                1e-5)),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                shape="x, dy bf16 [8192, 1536], w fp32 [1536]",
                fwd_checks={"rms_norm_fwd": fwd_err})


def phase_fused(torch, timer):
    """One flagship decoder layer after QKV/RoPE: q [4, 2048, 12, 128],
    k/v [4, 2048, 4, 128], resid [4, 2048, 1536], ffn 4096, bf16; weights
    at the model's init scale (std 0.02)."""
    from paddle_tpu_torch.ops.kernels import fused_block as fb
    b, s, hq, hkv, d = TRAIN_B, TRAIN_S, TRAIN_HQ, TRAIN_HKV, TRAIN_D
    hidden, ffn = TRAIN_HIDDEN, TRAIN_FFN

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda") * std).bfloat16()

    args = (rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d),
            rnd(b, s, hidden), torch.rand(hidden, device="cuda") + 0.5,
            rnd(hq * d, hidden, std=0.02), rnd(hidden, ffn, std=0.02),
            rnd(hidden, ffn, std=0.02), rnd(ffn, hidden, std=0.02))
    out = fb.fused_block(*args, eps=1e-5)
    ref = fb.fused_block_plain(*args, eps=1e-5)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    log(f"fused block: max_abs_err {err:.4g} of max "
        f"{float(ref.float().abs().max()):.4g}, rel L2 {_rel(out, ref):.3g}, "
        f"smem {fb.smem_bytes(hidden, d, torch.bfloat16)} B")
    assert torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-2), \
        f"fused block: max_abs_err {err} beyond rtol/atol 2e-2"
    tokens = b * s
    pairs = b * hq * s * (s + 1) // 2
    flops = (4 * d * pairs + 2 * tokens * hq * d * hidden
             + 3 * 2 * tokens * hidden * ffn)
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + out.numel() * 2)
    b_ms, b_by = bound(nbytes, flops, "bf16")
    return dict(name="fused_block_fwd", route="cuda",
                source="paddle_tpu_torch/csrc/fused_block.cu",
                replaces="paddle_tpu/ops/pallas/fused_block.py:222",
                path="train", max_abs_err=err,
                tolerance="rtol=atol=2e-2 (bf16 output)",
                ms=timer.ms(lambda: fb.fused_block(*args, eps=1e-5), iters=5),
                plain_ms=timer.ms(lambda: fb.fused_block_plain(*args,
                                                               eps=1e-5),
                                  iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape="bf16 q [4, 2048, 12, 128], k/v [4, 2048, 4, 128], "
                      "hidden 1536, ffn 4096")


# ------------------------------------------------------------ serve phase
def make_requests(GenerationRequest, np, rng, vocab):
    lens = [int(n) for n in np.linspace(32, 1024, 8).round()]
    prompts = [rng.randint(0, vocab, size=n).tolist() for n in lens]
    reqs = []
    for i, p in enumerate(prompts):
        if i < 6:
            reqs.append(GenerationRequest(i, p, max_new_tokens=32))
        else:
            reqs.append(GenerationRequest(i, p, max_new_tokens=32,
                                          temperature=0.8, top_p=0.95,
                                          seed=1000 + i))
    return prompts, reqs


def serve(torch, model, np, use_kernel=True):
    """One engine run over the 8 requests; returns outputs and a record
    of each step (wall seconds, prefill tokens, emitted tokens)."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    eng = GenerationEngine(model, max_seqs=8, max_seq_len=2048,
                           block_size=64, use_kernel=use_kernel)
    prompts, reqs = make_requests(GenerationRequest, np, np.random.RandomState(0),
                                  model.config.vocab_size)
    steps = []
    inner = eng.step

    def timed_step():
        p0, d0 = eng.stats["prefill_tokens"], eng.stats["decode_tokens"]
        t0 = time.perf_counter()
        inner()                      # ends in the step's host sync
        steps.append((time.perf_counter() - t0,
                      eng.stats["prefill_tokens"] - p0,
                      eng.stats["decode_tokens"] - d0))
    eng.step = timed_step
    t0 = time.perf_counter()
    out = eng.generate(reqs, return_details=True)
    wall = time.perf_counter() - t0
    return eng, prompts, out, steps, wall


def phase_serve(torch, np, layers, card):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    from paddle_tpu_torch.ops import kernels
    flags.set_flags({"pallas_fused_block": "off"})
    cfg = llama3_8b_config(dtype="bfloat16", num_hidden_layers=layers)
    log(f"serve: Llama-3-8B widths (hidden 4096, ffn 14336, vocab 128256, "
        f"rope theta 5e5, GQA 32:8), {layers} of 32 layers, bf16, seeded "
        f"random weights, pallas_fused_block=off")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"serve: model built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    # ---- the path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    eng, prompts, out, steps, wall = serve(torch, model, np)
    with torch.no_grad():   # scoring needs no graph
        scored = [model(torch.tensor([p], device=model.device))
                  for p in prompts]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"serve: path launches {counts}")

    # finish reasons, leaks, launch accounting
    reasons = {rid: d["finish_reason"] for rid, d in out.items()}
    assert all(r == "length" for r in reasons.values()), reasons
    assert all(len(d["output_ids"]) == 32 for d in out.values())
    assert eng.cache.free_blocks == eng.cache.num_blocks, "page leak"
    n_steps = eng.stats["steps"]
    assert counts["ragged_paged_attention"] == n_steps * layers, \
        (counts, n_steps)
    assert counts["flash_attention_fwd"] == len(prompts) * layers, counts
    assert counts["rms_norm_fwd"] == len(prompts) * (2 * layers + 1), counts
    for name in ("flash_attention_bwd", "rms_norm_bwd", "fused_block_fwd"):
        assert counts[name] == 0, counts
    for p, lg, d in zip(prompts, scored, out.values()):
        assert lg.shape == (1, len(p), cfg.vocab_size)
        assert bool(torch.isfinite(lg).all()), "non-finite logits"

    decode = [(dt, n) for dt, pre, n in steps if pre == 0]
    dec_tok = sum(n for _, n in decode)
    dec_s = sum(dt for dt, _ in decode)
    total_tok = sum(len(d["output_ids"]) for d in out.values())
    perf = dict(steps=n_steps, decode_only_steps=len(decode),
                decode_rows_per_step=dec_tok / len(decode) if decode
                else None,
                decode_tokens_per_s=dec_tok / dec_s if dec_s else None,
                decode_ms_per_step=1e3 * dec_s / len(decode)
                if decode else None,
                generate_s=wall, output_tokens_per_s=total_tok / wall,
                prefill_tokens=eng.stats["prefill_tokens"], card=card)
    log("serve: " + json.dumps(perf))

    # determinism: a second identical run, under the profiler, gives the
    # same streams bitwise
    holder = {}

    def rerun():
        holder["out"], holder["wall"] = serve(torch, model, np)[2::2]
    rows, busy, pwall = device_profile(torch, rerun)
    report_profile("serve", rows, busy, pwall, wall)
    assert holder["out"] == out, "second run differs"
    log("serve: second run bitwise equal (greedy and seeded)")

    # the same engine with the plain attention twin
    _, _, plain, _, _ = serve(torch, model, np, use_kernel=False)
    same = total = 0
    for rid in range(6):
        a, b = out[rid]["output_ids"], plain[rid]["output_ids"]
        same += sum(x == y for x, y in zip(a, b))
        total += len(a)
    agree = same / total
    log(f"serve: greedy agreement with the plain-twin engine {agree:.4f}")
    assert agree >= 0.99, f"greedy agreement {agree}"

    check_forward(torch, model, prompts[:3], scored[:3])
    return counts, perf


@contextlib.contextmanager
def plain_twins():
    """Every kernel wrapper the model calls goes to its plain twin inside
    the block (a reference, never a fallback)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_block as fb
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    patches = [(fa, "flash_attention_with_lse", fa.flash_attention_plain),
               (fa, "flash_attention_bwd", fa.flash_attention_bwd_plain),
               (rn, "rms_norm", rn.rms_norm_plain),
               (rn, "rms_norm_bwd", rn.rms_norm_bwd_plain),
               (fb, "fused_block", fb.fused_block_plain)]
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, twin in patches:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


def _rel(a, b) -> float:
    """``||a - b|| / ||b||`` in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_forward(torch, model, prompts, scored):
    """``LlamaForCausalLM.forward`` through the kernels against the plain
    twins, on decoder layer 0 and on the whole forward, both judged
    against an fp32 copy of the model run through the twins (``exact``).
    Relative L2 errors: the kernel path must be no further from ``exact``
    than 1.25x the twin path, and kernel vs twin must agree at the bf16
    tier (2e-2), or within twice the twin's own distance from ``exact``
    where bf16 rounding alone (32 layers of random weights) exceeds it."""
    with torch.no_grad():
        ids = [torch.tensor([p], device=model.device) for p in prompts]
        layer = model.llama.layers[0]
        emb = [model.llama.embed_tokens(x) for x in ids]
        with plain_twins():
            twin = [(layer(h), model(x)) for h, x in zip(emb, ids)]
        kern = [(layer(h), lg) for h, lg in zip(emb, scored)]
        model32 = copy.deepcopy(model).float()
        with plain_twins():
            exact = [(model32.llama.layers[0](h.float()), model32(x))
                     for h, x in zip(emb, ids)]
    del model32
    torch.cuda.empty_cache()
    for x, k, t, e in zip(ids, kern, twin, exact):
        for what, i in (("layer 0", 0), ("forward", 1)):
            r_k, r_t, r_kt = _rel(k[i], e[i]), _rel(t[i], e[i]), \
                _rel(k[i], t[i])
            msg = (f"{what} s={x.shape[1]}: rel err vs fp32 kernel "
                   f"{r_k:.4g}, twin {r_t:.4g}; kernel vs twin {r_kt:.4g} "
                   f"(max_abs {max_err(k[i], t[i]):.4g})")
            if i:
                agree = float((k[1].argmax(-1) == t[1].argmax(-1))
                              .float().mean())
                msg += f", argmax agreement {agree:.4f}"
            log("serve: " + msg)
            assert r_k <= 1.25 * r_t + 1e-6, msg
            assert r_kt <= max(2e-2, 2 * r_t), msg


def device_profile(torch, fn):
    """``fn()`` under ``torch.profiler``: device time by kernel (largest
    first) as ``(us, count, name)`` rows, their sum in seconds, and the
    profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue      # host ops repeat their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows) / 1e6, wall


def report_profile(label, rows, busy, wall, plain_wall, top=12):
    """Busy share of the profiled wall and of the same work's unprofiled
    wall (``plain_wall``), and the top kernels."""
    if not rows:
        log(f"{label} profile: the profiler saw no device time (not "
            f"measured)")
        return None
    log(f"{label} profile: kernels {busy:.3f} s over a profiled wall of "
        f"{wall:.3f} s ({busy / wall:.3f}) and an unprofiled wall of "
        f"{plain_wall:.3f} s ({busy / plain_wall:.3f})")
    for us, n, name in rows[:top]:
        log(f"{label} profile: {us / 1e3:10.2f} ms "
            f"{100 * us / 1e6 / busy:6.2f}% x{n:<6d} {name[:90]}")
    return busy / plain_wall


# ------------------------------------------------------------ train phase
def flagship_config():
    """``bench.py:2315-2320``: the ~400M Llama the JAX bench trains."""
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=1536,
                       intermediate_size=4096, num_hidden_layers=TRAIN_LAYERS,
                       num_attention_heads=12, num_key_value_heads=4,
                       max_position_embeddings=2048, dtype="bfloat16",
                       recompute=False)


def build_trainer(torch, cfg):
    """``_llama_run``'s model, optimizer and step (``bench.py:62-90``)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, seed=0)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.1,
                                 parameters=model.parameters())

    @paddle.jit.to_static
    def train_step(ids):
        loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return model, opt, train_step


def loss_and_grads(torch, model, ids):
    """One forward and backward (no update): the fp32 loss and every
    parameter's gradient as fp32, then the gradients are cleared."""
    loss, _ = model(ids, labels=ids)
    loss.backward()
    grads = [p.grad.float() for p in model.parameters()]
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def check_train_step(torch, model, ids):
    """One step's loss and gradients from the model's current weights
    through the kernels, through the plain twins, and through the twins
    on an fp32 copy (``exact``): the losses agree at the bf16 tier, the
    kernel gradients (relative L2 over all parameters) are no further
    from ``exact`` than 1.25x the twin gradients are, and no parameter's
    kernel gradient is further from ``exact`` than 1.5x its twin
    gradient."""
    loss_k, g_k = loss_and_grads(torch, model, ids)
    with plain_twins():
        loss_t, g_t = loss_and_grads(torch, model, ids)
        model32 = copy.deepcopy(model).float()
        loss_e, g_e = loss_and_grads(torch, model32, ids)
    del model32
    torch.cuda.empty_cache()

    def dist(a, b):
        num = sum(float((x - y).square().sum()) for x, y in zip(a, b))
        den = sum(float(y.square().sum()) for y in b)
        return math.sqrt(num / den)

    r_k, r_t, r_kt = dist(g_k, g_e), dist(g_t, g_e), dist(g_k, g_t)
    names = [n for n, _ in model.named_parameters()]
    worst = max(((_rel(a, e) / max(_rel(t, e), 1e-12), n)
                 for n, a, t, e in zip(names, g_k, g_t, g_e)
                 if float(e.norm()) > 0))
    msg = (f"train check: loss kernel {loss_k:.6f}, twin {loss_t:.6f}, fp32 "
           f"{loss_e:.6f}; grads rel L2 vs fp32: kernel {r_k:.4g}, twin "
           f"{r_t:.4g}, kernel vs twin {r_kt:.4g}; worst parameter ratio "
           f"{worst[0]:.3f} ({worst[1]})")
    log(msg)
    assert abs(loss_k - loss_t) <= 2e-2 * abs(loss_t) + 2e-2, msg
    assert r_k <= 1.25 * r_t + 1e-6, msg
    # per parameter too, so that a fault confined to a few layers'
    # gradients is not diluted by the large embedding and head gradients
    assert worst[0] <= 1.5, msg
    return dict(loss_kernel=loss_k, loss_twin=loss_t, loss_fp32=loss_e,
                grad_rel_l2_kernel=r_k, grad_rel_l2_twin=r_t)


def phase_train(torch, np, card):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import kernels
    paddle.flags.set_flags({"pallas_fused_block": "auto"})
    torch.use_deterministic_algorithms(True, warn_only=True)
    layers, steps = TRAIN_LAYERS, TRAIN_STEPS
    cfg = flagship_config()
    batch, seq, warmup = TRAIN_B, TRAIN_S, 2
    log(f"train: flagship Llama (bench.py:2315: vocab 32000, hidden 1536, "
        f"ffn 4096, GQA 12:4, head_dim 128), {layers} layers, bf16, "
        f"batch {batch} x seq {seq}, AdamW(lr 1e-4, wd 0.1), seeded random "
        f"weights, pallas_fused_block=auto")
    model, opt, train_step = build_trainer(torch, cfg)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(batch, seq))
                           .astype("int32")).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train: {n_params / 1e6:.1f}M parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup + 1):
        losses.append(train_step(ids))
    torch.cuda.synchronize()
    log(f"train: {warmup + 1} warmup steps in {time.perf_counter() - t0:.2f}"
        f" s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # ---- the path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(train_step(ids))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"train: path launches {counts}")
    want = dict(fused_block_fwd=layers, flash_attention_fwd=layers,
                flash_attention_bwd=layers, rms_norm_fwd=2 * layers + 1,
                rms_norm_bwd=2 * layers + 1, ragged_paged_attention=0)
    for name, per_step in want.items():
        assert counts[name] == per_step * steps, (name, counts)

    vals = [float(x) for x in losses]
    log(f"train: losses {vals}")
    assert all(math.isfinite(x) for x in vals), "non-finite loss"
    assert vals[-1] < vals[0], "the loss on the fixed batch did not fall"

    tps = batch * seq * steps / dt
    flops_per_token = 6 * n_params + 12 * layers * cfg.hidden_size * seq
    mfu = tps * flops_per_token / PEAK_FLOPS["bf16"]
    perf = dict(tokens_per_s=tps, ms_per_step=1e3 * dt / steps, mfu=mfu,
                steps=steps, n_params=n_params, loss_first=vals[0],
                loss_last=vals[-1],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                card=card)
    log("train: " + json.dumps(perf))

    rows, busy, pwall = device_profile(
        torch, lambda: [train_step(ids) for _ in range(2)])
    perf["busy_share"] = report_profile("train", rows, busy, pwall,
                                        2 * dt / steps, top=15)

    perf.update(check_train_step(torch, model, ids))

    # a second run from the seed repeats the first steps bitwise
    first = losses[:warmup + 1]
    del model, opt, train_step
    torch.cuda.empty_cache()
    model, opt, train_step = build_trainer(torch, cfg)
    again = [train_step(ids) for _ in range(len(first))]
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"train: second run from the seed, {len(first)} steps: "
        f"{'bitwise equal' if same else 'DIFFERS'} "
        f"({[float(x) for x in again]})")
    assert same, "a second run from the seed differs"
    del model, opt, train_step
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return counts, perf


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of the served model (of 32)")
    args = ap.parse_args()
    if not __debug__:
        print("chip_smoke: the checks are asserts; run without -O",
              file=sys.stderr)
        return 2
    # cuBLAS repeats bitwise only with a fixed workspace; set before the
    # first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "an NVIDIA GPU and has no CPU mode", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: paddle_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t_start = time.perf_counter()
        card = smi()
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(card)

        from paddle_tpu_torch.ops.kernels import _build
        _build.library()
        log(f"build: {_build.build_seconds():.1f} s "
            f"({len(_build.SOURCES)} sources, nvcc sm_90a)")
        for ln in _build.ptxas_report().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                log(f"build: ptxas {ln.strip()[:150]}")

        torch.manual_seed(0)
        timer = Timer(torch)
        rows = []
        for phase in (lambda: phase_ragged(torch, timer,
                                           np.random.RandomState(0)),
                      lambda: phase_flash(torch, timer),
                      lambda: phase_rms(torch, timer),
                      lambda: phase_flash_bwd(torch, timer),
                      lambda: phase_rms_bwd(torch, timer),
                      lambda: phase_fused(torch, timer)):
            r = phase()
            rows.append(r)
            log(f"kernel {r['name']}: {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3g} (tol {r['tolerance']}), "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}) on {card}")
            torch.cuda.empty_cache()
        by_name = {r["name"]: r for r in rows}
        for r in rows:
            for name, err in r.pop("fwd_checks", {}).items():
                by_name[name]["max_abs_err"] = max(
                    by_name[name]["max_abs_err"], err)
        del timer
        log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

        counts = {"serve": phase_serve(torch, np, args.layers, card)[0]}
        torch.cuda.empty_cache()
        log(f"serve done at {time.perf_counter() - t_start:.1f} s")
        counts["train"] = phase_train(torch, np, card)[0]
        log(f"train done at {time.perf_counter() - t_start:.1f} s")
        for r in rows:
            r["launches"] = counts[r["path"]][r["name"]]
            r["launches_by_path"] = {p: c[r["name"]]
                                     for p, c in counts.items()}
            assert r["launches"] > 0, \
                f"{r['name']} not on the {r['path']} path"
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "path", "launches_by_path")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card)
        log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                    for r in rows]}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
