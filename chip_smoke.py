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
   checked too; the grouped GEMMs at the MoE training shapes, an
   expert-major buffer of 65,536 rows with 32,768 live over 16 experts,
   one empty and one full, and gmm/gmm2 also in fp32 at the MoE serving
   shapes, gmm2 beside the unfused route's two gmm launches; the chunked
   SSD scan at the hybrid's prefill and at ``bench_ssm_pretrain``'s
   widths; paged decode attention at the eager serve step and the
   hybrid's; ragged attention over quantized pages at #8's shape over int8
   and fp8 pages, with a bf16 q and pads, and at the serve-quant step's;
   the segment-causal flash forward and backward at every zig-zag
   descriptor of sp 2 and 4 over a global 4096, 16:8 heads of 64, bf16
   and fp32, with splits no tile divides, then each rank's pieces at the
   train-cp path's global 32768, merged by lse against the flash forward
   over the whole causal sequence and summed against the flash backward)
   held against its plain PyTorch twin on the same inputs (each backward
   kernel, the dx gmm, the scan and the quantized ragged kernel also
   twice, bitwise), then timed beside the twin, the PyTorch library call
   that computes the same function (where one exists: ``grouped_mm`` for
   gmm and gmm2, ``torch.bmm`` with an fp32 output over the padded buffer
   for tgmm, memory-efficient ``scaled_dot_product_attention`` with the
   segment mask for the segment-causal pair) and the least time the card
   could take;
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
5. serve-int8, the serve phase once more with ``kv_quant="int8"`` (the
   same model and requests over int8 pages). Checks: no page leak,
   quantized ragged launches == steps x layers and no other kernel, greedy
   tokens >= 99% equal to the int8 engine on the plain twins. Reports the
   step's time and tokens/s beside the bf16-page run's and the share of
   greedy tokens equal to it (not asserted: bf16 random weights);
6. serve-eager, the slice-4 eager engine on the serve phase's model and
   requests (``mode="eager"``: each prompt prefilled whole at admission
   through flash attention, then a Python layer walk per step with the
   paged decode kernel, host numpy sampling). Checks: finish reasons, no
   page leak, paged launches == steps x layers, flash launches == prompts
   x layers, a second (profiled) run bitwise equal, and, with every engine
   fed the kernel run's tokens, the kernels' logits no further from an
   fp32 copy's than 1.25x the plain twins' are. Reports the step's time,
   the host's CPU share and the share of the steps spent in host
   sampling, the share of greedy tokens equal to the compiled engine's and
   the shares the twins and the fp32 copy would choose too (not asserted:
   32 bf16 layers of random weights differ by rounding alone);
7. serve-fleet, the slice-8 path, right after serve-eager: the
   disaggregated fleet at the serve phase's widths and depth. First #18 (the
   KV-page remote copy) in two ``distributed.spawn`` ranks sharing the card
   over gloo: the path's largest record (bf16 K and V [32768, 8, 128], a
   1024-token prompt at 32 layers) and an int8 page segment with its fp32
   scales moved from rank 0 to rank 1 by the kernel and by its twin (a gloo
   ``ppermute`` through the host), bit for bit, one launch a call; then the
   bf16 segment timed (the kernel's pull from the peer's mapped slot, the
   library's ``Tensor.copy_`` of the same view, the twin, the whole SPMD
   call) beside its bound. Then the serve model rebuilt from its seed serves
   every request of the phase one at a time through a one-process
   ``GenerationServer`` (the baselines) and leaves this process; a master,
   a ``FleetSupervisor`` and a ``FleetRouter`` bring up three
   ``serve_host`` processes on the card from the reference's spec schema
   (``pf0`` prefill, ``dc0`` and ``dc1`` decode; ``max_seqs`` 8,
   ``max_seq_len`` 2048, block 64; no TF32 and a fixed cuBLAS workspace
   through their environment), each reporting a parameter digest equal to
   the baseline model's. Legs: (a) the serve requests one at a time, each
   prompt prefilled on ``pf0`` and its pages pulled by a decode host with
   #18 from ``pf0``'s exported buffer, every stream bit for bit the
   one-process run's, #18 launches == handoffs x 2 (K and V), no page leak,
   no IPC buffer left held; (b) the hosts respawned with
   ``FLAGS_use_pallas_kernels=0``, the same requests over packed bytes, bit
   for bit again, no #18 launch; (c) the hosts respawned on the device
   route, 8 requests from another seed at once, ``dc1`` SIGKILLed while it
   decodes one: every request finishes ``length`` with 32 tokens, every
   stream append-only and equal to the journal's, ``failovers >= 1``, no
   leak on the live hosts, no IPC buffer held on ``pf0``, the master's
   incident closed with a finite MTTR; the share of greedy tokens equal to
   the one-process runs is reported, not asserted (concurrent batches
   round bf16 differently); (d) ``ensure`` respawns ``dc1``, which serves
   one more request bit for bit its one-process run. Reports TTFT and
   end-to-end latency (p50, p99), goodput and the handoff's time split
   (export gather, stage or pack, transport, install) for each leg;
8. serve-quant, the quantized memory plane: ``bench_serve_llama_quant``'s
   configuration and traffic (``bench.py:1758-1884``: 8 layers, hidden
   1024, ffn 2816, 16:8 heads of 64, vocab 32000, block 64, ``max_seqs``
   64, seeded random weights), nothing cut. Checks: equal-byte KV pools
   (a bf16 engine at 128 blocks, an int8 one sized by
   ``bytes_per_block``) admit >= 1.8x as many 511-token prompts over int8
   pages; then 8 greedy requests (16 new tokens) through an fp32 copy
   (seed 0), unquantized and over int8 pages: top-1 agreement >= 0.99, no
   leak in either, quantized ragged launches == steps x layers and the
   full-width ragged kernel none, a profiled repeat bitwise equal, >= 99%
   of greedy tokens equal to the plain twins, with weight-only int8 too;
9. serve-moe, the slice-3 serving path: the train-moe configuration
   (phase 12; seeded random weights), run before the training phases as
   a serving process would, through ``GenerationEngine(max_seqs=16,
   max_seq_len=160, block_size=64)``, 16 prompts of 64 tokens, 32 new
   tokens each, 2 of them sampled. Checks: finish reasons, no page leak,
   ragged, gmm2 and gmm launches == steps x layers, a second timed run
   and a third, profiled, bitwise equal, greedy tokens >= 99% equal to
   the plain-twin engine; then once more with ``moe_fused_wi=False``
   (gmm2 launches 0, gmm == steps x layers x 3, greedy tokens >= 99%
   equal to the fused run's). Reports the host's CPU time over the wall
   and device kernels per step (the step is issued op by op);
10. serve-ssm, the slice-4 hybrid path: ``bench_serve_ssm``'s on-chip
   configuration (``bench.py:1972-2078``: an fp32 hybrid of 8 layers "SA",
   hidden 1024, ffn 2816, 8:8 heads of 128, d_state 16, SSM head dim 32,
   seeded random weights). Checks: equal-byte KV pools admit >= 2x as many
   1023-token prompts for the hybrid as for the attention-only Llama; then
   8 greedy requests (32 new tokens) through the compiled and the eager
   engine, each after a warm run: finish reasons, scan launches ==
   admissions x SSM layers, ragged (compiled) or paged (eager) launches ==
   steps x attention layers, no page leak, every slot's state zero after
   the drain, a profiled repeat bitwise equal, >= 99% of greedy tokens
   equal to the same engine on the plain twins and compiled equal to
   eager;
11. train, the slice-2 path: ``bench.py:_llama_run`` at the flagship
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
12. train-moe, the slice-3 training path: ``bench_moe``'s on-chip
   configuration (``bench.py:122-129``: vocab 32000, hidden 1024, 16
   experts of ffn 704, top-2 gshard at capacity factor 2.0, aux weight
   0.01, 6 layers, 16:16 heads, bf16), batch 8 x seq 2048, trained as in
   phase 11 (2+1 warmup, 10 timed steps, AdamW, one fixed batch). Reports
   tokens/s, ms per step, the bench's activated-parameter MFU, busy share
   and top kernels, peak memory. Checks: finite, falling losses; per step
   6 gmm2, 6 + 18 gmm (forward, and the dx against w^T), 18 tgmm, 6 flash
   forward and backward and 13 of each RMSNorm kernel; one step's
   gradients against the twins and an fp32 copy (with the share of
   (token, k) routes the fp32 copy also takes); a second run bitwise;
13. train-cp, the slice-6 context-parallel path: ``bench_cp_long_context``
   (``bench.py:323-371``: vocab 32000, hidden 1024, ffn 2816, 4 layers,
   16:8 heads of 64, bf16, ``sequence_parallel=True``, ``sep_mode="auto"``,
   seq 32768, batch 1, seeded random weights; the bench's 64k row is left
   out), trained as ``_llama_run`` trains it (1 + 1 warmup and 2 timed
   AdamW steps): (a) in this process without a mesh (flash forward and
   backward over the whole causal sequence), (b) as two
   ``distributed.spawn`` ranks sharing this one card over a gloo group
   (NCCL refuses two ranks on one GPU) on a ``["sep"]`` mesh, where
   attention is the zig-zag ring: its KV and dk/dv hops go device to
   device through the IPC hop kernel (``ring_kv_rotate``, first held
   against its twin, a gloo ``ppermute`` through the host, bit for bit at
   the path's shape and timed beside it and beside the library's
   ``Tensor.copy_`` of K and V from the peer's mapped slot), its
   all-gathers through the
   host. Checks: falling finite losses; both ranks the same loss and
   parameter bits; per step and rank 4 segment-causal forwards, 8
   segment-causal backwards, 4 flash forwards, 32 hop launches (16 hops),
   no flash backward and no fused block; step 1's loss within 2e-2 of
   (a)'s, the model's gradients within 2e-2 rel L2 of (a)'s and every
   parameter's within ``CP_LEAF_LIMIT``, a limit a planted ring fault
   (rank 0 drops one backward step's dk/dv) must exceed; a second (b) from the seed bitwise equal.
   Reports tokens/s, ms per step and MFU of both (one card's peak: the
   ranks share it, so this is not context-parallel scaling) and the
   shares of (b)'s step spent in the host-staged all-gathers and in the
   IPC hops;
14. train-moe-ep, the slice-7 expert-parallel path: the train-moe model
   and batch (phase 12) trained with AdamW on an ``["ep"]`` mesh of two
   ``distributed.spawn`` ranks sharing this card over gloo, each rank
   holding the replicated model with 8 of the 16 experts (``shard_layer``
   with ``llama_shard_fn``) and dispatching 8,192 of the 16,384 tokens
   through the ragged all-to-all. Each rank first holds the tiled
   all-to-all kernel (#15) bit for bit against its twin (a gloo exchange
   through the host) at the path's payloads (bf16 [32768, 1024], its int32
   ids, a chunk pair [16384, 1024]) and the comm-fused dispatch + expert
   MLP kernel (#17) against its twin (the exchange, the inv gather, the
   grouped-GEMM twins) on the path's packed inputs at one and two chunks,
   in fp32, and at cf 1.0 with an expert no token routes to (a second
   launch bitwise), and against the TPU kernel's arithmetic (gate and up
   kept in fp32, where #17 and its twin round them to the compute dtype)
   at the same tiers, and times each beside its twin, #17 also beside a
   gather and ``grouped_mm`` for gate, up and down. Then three modes from
   the seed, 1 + 1 warmup and 3 timed steps each: (b1) the default flags
   (#17 at one chunk), (b2) ``moe_a2a_overlap`` (#17 owns both chunks),
   (b3) ``moe_a2a_fused_kernel=off`` (the composed pipelined path). Checks:
   launches per step and rank as the code makes them (``ep_want``);
   falling finite losses; both ranks the same loss bits and the same bits
   in every parameter (the experts gathered back); step 1's loss within
   the bf16 tier of one process at the same seed and batch, its gradients
   within 2e-2 rel L2 over the model and each parameter's within
   ``EP_LEAF_LIMIT``, which a planted fault (a second spawn: rank 0 drops
   its peer's block of every combine) must exceed. Reports ms per step,
   tokens/s, the activated-parameter MFU against one card and the shares
   of the step in the host-staged all-gathers and in #15/#17. Last, (c),
   ``bench_moe_overlap_efficiency`` (``bench.py:176-260``: an fp32
   ``MoELayer``, hidden 1024, 16 experts of ffn 2816, gshard cf 2.0, 16
   tokens a rank) as four ranks sharing the card on an ``["ep"]`` mesh of
   four, so that #15 and #17 run with three peers: its output against the
   one-device layer, then fwd + bwd + AdamW with ``moe_a2a_overlap`` off
   and on (the ratio reported, not asserted);
15. the ``kernels`` JSON line, then the result line.

fp32 matmuls run without TF32 throughout (``allow_tf32 = False``), so the
twins and the serving step's fp32 projections are full fp32.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
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
# #8's timing shape (#10 is timed at it too): 7 decode rows, one
# 64-token prompt chunk and a pad row over 8 sequences of 32 blocks
RAGGED_LENS = [130, 257, 385, 512, 640, 771, 1000]
RAGGED_ROWS = list(range(7)) + [7] * 64 + [0]
RAGGED_VALIDS = RAGGED_LENS + list(range(449, 513)) + [0]


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
    # 7 decode rows, a chunk at positions 448..511, a pad
    rows, valids = RAGGED_ROWS, RAGGED_VALIDS
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
    """Causal bf16 [1, 2048, 32|8, 128], and a ragged length (1000); head
    dim 64 at 16:8 heads, causal and (train-cp (b)'s half slices) full with
    Sq != Sk. Timed at the table's shape and at train-cp (a)'s q [1, 32768,
    16, 64], kv 8, each beside its bound and SDPA."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    res = 0.0
    tol = 2e-2   # bf16 output: p is rounded to bf16 against a running max
    #              in the kernel and against the row max in the twin
    for sq, sk, hq, hkv, d, causal in ((1000, 1000, 32, 8, 128, True),
                                       (2048, 2048, 16, 8, 64, True),
                                       (1024, 2048, 16, 8, 64, False),
                                       (2048, 2048, 32, 8, 128, True)):
        q = torch.randn(1, sq, hq, d, device="cuda").bfloat16()
        k = torch.randn(1, sk, hkv, d, device="cuda").bfloat16()
        v = torch.randn(1, sk, hkv, d, device="cuda").bfloat16()
        o, lse = fa.flash_attention_with_lse(q, k, v, causal)
        ro, rlse = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err, lerr = max_err(o, ro), max_err(lse, rlse)
        assert err <= tol and lerr <= 1e-4, \
            f"flash {sq}x{sk} d={d} causal={causal}: max_abs_err {err} " \
            f"(lse {lerr})"
        log(f"flash q [1, {sq}, {hq}, {d}], kv [1, {sk}, {hkv}, {d}], "
            f"causal={causal}: max_abs_err {err:.3g}, lse err {lerr:.3g}")
        res = max(res, err)
    del o, lse, ro, rlse

    def timed(q, k, v):
        s, hq, d = q.shape[1], q.shape[2], q.shape[3]
        fn, lib_args = _sdpa_lib(torch, q, k, v)
        flops = 4 * hq * d * s * (s + 1) // 2
        nbytes = (q.numel() * 2 + k.numel() * 2 * 2 + q.numel() * 2
                  + hq * s * 4)
        b_ms, b_by = bound(nbytes, flops, "bf16")
        return (timer.ms(lambda: fa.flash_attention_with_lse(q, k, v, True)),
                b_ms, b_by, timer.ms(lambda: fn(*lib_args)))

    ms, b_ms, b_by, lib_ms = timed(q, k, v)
    row = dict(name="flash_attention_fwd", route="cuda",
               source="paddle_tpu_torch/csrc/flash_attention.cu",
               replaces="paddle_tpu/ops/pallas/flash_attention.py:130",
               path="serve", max_abs_err=res, tolerance=tol, ms=ms,
               plain_ms=timer.ms(lambda: fa.flash_attention_plain(q, k, v,
                                                                  True)),
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               shape="causal bf16 q [1, 2048, 32, 128], k/v [1, 2048, 8, 128]")
    del q, k, v
    torch.cuda.empty_cache()
    q = torch.randn(1, CP_SEQ, 16, 64, device="cuda").bfloat16()
    k, v = (torch.randn(1, CP_SEQ, 8, 64, device="cuda").bfloat16()
            for _ in range(2))
    cp = timed(q, k, v)
    row["cp"] = dict(zip(("ms", "bound_ms", "bound_by", "library_ms"), cp),
                     shape=f"causal bf16 q [1, {CP_SEQ}, 16, 64], k/v [1, "
                           f"{CP_SEQ}, 8, 64] (train-cp (a))")
    log(f"flash at train-cp (a)'s shape: " + json.dumps(row["cp"]))
    return row


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


def _sdpa_bwd_lib(torch, timer, q, k, v, do):
    """SDPA's backward on [b, h, s, d] views of the port's tensors, causal,
    with the backend pinned (``torch.nn.attention.sdpa_kernel``): the
    first of flash, memory-efficient, cuDNN and math that takes the call,
    with ``enable_gqa`` where it does (else K/V repeated outside the call,
    and the group sum left out). Returns ``(ms, backend)``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    do_t = do.transpose(1, 2)
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for gqa in (True, False):
            kk, vv = (k, v) if gqa else (
                x.repeat_interleave(g, dim=2) for x in (k, v))
            ins = [x.transpose(1, 2).detach().requires_grad_(True)
                   for x in (q, kk, vv)]
            try:
                with sdpa_kernel([backend]):
                    out = F.scaled_dot_product_attention(
                        *ins, is_causal=True,
                        **({"enable_gqa": True} if gqa and g > 1 else {}))
                fn = lambda: torch.autograd.grad(out, ins, do_t,
                                                 retain_graph=True)
                fn()
                torch.cuda.synchronize()
            except (RuntimeError, TypeError):
                continue
            name = backend.name + ("" if gqa or g == 1
                                   else " (K/V repeated)")
            return timer.ms(fn), name
    return None, None


def _bwd_launches(torch, label, fn):
    """Device time of each kernel of ``fn()`` (the dQ and dK/dV launches
    named apart) from ``torch.profiler``, ms a launch by kernel name."""
    rows, _, _ = device_profile(torch, fn)
    out = {}
    for us, n, name in rows:
        log(f"{label} profile: {us / 1e3 / n:.4f} ms a launch x{n} "
            f"{name[:90]}")
        for short in ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"):
            if short in name:
                out[short] = us / 1e3 / n
    return out


def _bwd_flops(b, s, hq, d):
    """The causal backward's products: 10*d flops a visible pair and
    head."""
    return 10 * d * b * hq * s * (s + 1) // 2


def phase_flash_bwd(torch, timer):
    """The backward at the flagship's attention shape: causal bf16 q
    [4, 2048, 12, 128], k/v [4, 2048, 4, 128] (GQA 3:1). The forward
    kernel is held against its twin at this shape first, with the
    serving shape's tolerances. Timed beside SDPA's backward with its
    backend pinned, and at train-cp (a)'s q [1, 32768, 16, 64], kv 8
    (no twin there: its score matrix alone would be tens of GB)."""
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
    del want, got, again
    torch.cuda.empty_cache()
    lib_ms, backend = _sdpa_bwd_lib(torch, timer, q, k, v, do)
    b_ms, b_by = bound(q.numel() * 2 * 3 + k.numel() * 2 * 4
                       + lse.numel() * 4, _bwd_flops(b, s, hq, d),
                       "bf16")
    row = dict(name="flash_attention_bwd", route="cuda",
               source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
               replaces="paddle_tpu/ops/pallas/flash_attention.py:303",
               path="train", max_abs_err=err,
               tolerance="rtol 2e-2, atol 2e-2 x max|twin|; bitwise repeat",
               ms=timer.ms(lambda: fa.flash_attention_bwd(*args)),
               plain_ms=timer.ms(lambda: fa.flash_attention_bwd_plain(*args),
                                 iters=3, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               library=f"SDPA backward, {backend}",
               launches_ms=_bwd_launches(
                   torch, "flash bwd (train shape)",
                   lambda: [fa.flash_attention_bwd(*args) for _ in range(5)]),
               shape="causal bf16 q [4, 2048, 12, 128], k/v [4, 2048, 4, 128]",
               fwd_checks={"flash_attention_fwd": fwd_err})
    log(f"flash bwd at the train shape: {row['ms']:.4f} ms (dQ and dK/dV "
        f"{row['launches_ms']}), SDPA backward ({backend}) {lib_ms} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    del q, k, v, do, o, lse, args
    torch.cuda.empty_cache()
    q = torch.randn(1, CP_SEQ, CP_HQ, CP_D, device="cuda").bfloat16()
    k, v = (torch.randn(1, CP_SEQ, CP_HKV, CP_D, device="cuda").bfloat16()
            for _ in range(2))
    do = torch.randn(1, CP_SEQ, CP_HQ, CP_D, device="cuda").bfloat16()
    o, lse = fa.flash_attention_with_lse(q, k, v, True)
    args = (q, k, v, o, lse, do, True)
    got = fa.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got), \
        "flash bwd at train-cp (a)'s shape: non-finite gradients"
    del got
    cp_lib, cp_backend = _sdpa_bwd_lib(torch, timer, q, k, v, do)
    cp_b = bound(q.numel() * 2 * 3 + k.numel() * 2 * 4 + lse.numel() * 4,
                 _bwd_flops(1, CP_SEQ, CP_HQ, CP_D), "bf16")
    row["cp"] = dict(ms=timer.ms(lambda: fa.flash_attention_bwd(*args),
                                 iters=3, warmup=1),
                     bound_ms=cp_b[0], bound_by=cp_b[1], library_ms=cp_lib,
                     library=f"SDPA backward, {cp_backend}",
                     launches_ms=_bwd_launches(
                         torch, "flash bwd (train-cp (a) shape)",
                         lambda: fa.flash_attention_bwd(*args)),
                     shape=f"causal bf16 q [1, {CP_SEQ}, 16, 64], k/v [1, "
                           f"{CP_SEQ}, 8, 64] (train-cp (a))")
    log(f"flash bwd at train-cp (a)'s shape: " + json.dumps(row["cp"]))
    return row


# the context-parallel path's attention (bench_cp_long_context,
# bench.py:323-371): 16:8 heads of 64, bf16; each rank of sp=2 holds
# 16,384 of the 32,768 tokens
CP_SEQ, CP_SP, CP_HQ, CP_HKV, CP_D = 32768, 2, 16, 8, 64


def _zigzag_rows(s, sp, idx):
    """Global rows of rank ``idx``'s zig-zag chunks ``(idx, 2sp-1-idx)``."""
    c = s // (2 * sp)
    return list(range(idx * c, (idx + 1) * c)) + list(
        range((2 * sp - 1 - idx) * c, (2 * sp - idx) * c))


def _seg_qkv(torch, s, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(1, s, h, CP_D, device="cuda", generator=g).to(dtype)
            for h in (CP_HQ, CP_HKV, CP_HKV, CP_HQ)]


def _lse_err(torch, a, b) -> float:
    """max |a - b| over finite entries; the -inf entries (rows with
    nothing visible) must agree exactly."""
    ia, ib = torch.isneginf(a), torch.isneginf(b)
    assert torch.equal(ia, ib), "lse: the rows with nothing visible differ"
    return max_err(a[~ia], b[~ib]) if bool((~ia).any()) else 0.0


def _seg_cases(s_list=((4096, 2), (4096, 4), (4000, 2))):
    """Every descriptor the zig-zag ring issues at sp 2 and 4 over a
    global 4096, and at sp 2 over 4000 (chunks of 1000 rows: tiles of 64
    straddle every split)."""
    from paddle_tpu_torch.distributed.sequence_parallel import _zigzag_seg
    for s, sp in s_list:
        c = s // (2 * sp)
        for idx in range(sp):
            for src in range(sp):
                yield s, sp, idx, src, _zigzag_seg(idx, src, c, sp)


def _row_scaled_err(torch, got, want) -> float:
    """The worst row's max |got - want| over that row's max |want| (rows
    along the last axis): a key too many or too few on a long row moves
    its output by far more than rounding, while an absolute limit is
    several times the output itself there. A row whose twin is all zero
    must be zero too."""
    g, w = got.float(), want.float()
    scale = w.abs().amax(dim=-1, keepdim=True)
    diff = (g - w).abs()
    zero = scale == 0
    assert not bool(diff.masked_fill(~zero, 0).any()), \
        "a row the twin leaves at zero is not zero"
    return float((diff / scale.masked_fill(zero, 1)).amax())


def _live_pairs(torch, seg, sq, sk) -> int:
    """(row, col) pairs the segment mask keeps: the work #3/#4 must do."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    gq = fa.seg_positions(*seg[:3], sq, "cuda")
    gk = fa.seg_positions(*seg[3:], sk, "cuda")
    return int(torch.searchsorted(gk, gq, right=True).sum())


def _sdpa_seg_lib(torch, q, k, v, seg):
    """``scaled_dot_product_attention`` (memory-efficient backend) with
    the segment mask as an additive ``attn_mask`` and K/V repeated to the
    query heads, on [b, h, s, d] views: the library call that computes
    #3's function. Returns ``(fn, args)`` or None where the backend
    refuses it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    sq, sk = q.shape[1], k.shape[1]
    keep = fa._seg_keep(seg, sq, sk, "cuda")
    mask = torch.zeros(sq, sk, dtype=q.dtype, device="cuda").masked_fill(
        ~keep, float("-inf"))
    del keep
    g = q.shape[2] // k.shape[2]
    args = (q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
            v.repeat_interleave(g, dim=2).transpose(1, 2))

    def fn(a, b_, c):
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(a, b_, c, attn_mask=mask)
    try:
        fn(*args)
    except RuntimeError as e:
        log(f"flash seg: the library call was refused ({e}); library_ms "
            f"null")
        return None
    return fn, args


def phase_flash_seg(torch, timer):
    """#3, the segment-causal forward. (1) Against its twin, bf16 and
    fp32, for every zig-zag descriptor at sp 2 and 4 over a global 4096
    (16:8 heads of 64) and at sp 2 over 4000 (straddling splits). (2) The
    single-process ring check at the path's global 32768, bf16: for sp 2
    and 4 each rank's pieces over every source, merged by their lse as
    the ring merges them, against #1 over the whole causal sequence.
    (3) Against its twin at the path's shape, q [1, 16384, 16, 64], kv
    [1, 16384, 8, 64], bf16, both ranks' t=0 descriptors at sp 2, one kv
    head at a time, each output row to 2e-2 of its own max|twin|. (4)
    Timed at that shape, rank 0's t=0 descriptor."""
    from paddle_tpu_torch.distributed.sequence_parallel import (_merge,
                                                                _zigzag_seg)
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    worst = {}
    for dtype, tol, ltol in ((torch.bfloat16, 2e-2, 1e-4),
                             (torch.float32, 2e-5, 1e-5)):
        qkv = {}
        for s, sp, idx, src, seg in _seg_cases():
            if s not in qkv:
                qkv = {s: _seg_qkv(torch, s, dtype, seed=s)}
            q, k, v, _ = qkv[s]
            rq, rk = _zigzag_rows(s, sp, idx), _zigzag_rows(s, sp, src)
            ql, kl, vl = q[:, rq], k[:, rk], v[:, rk]
            o, lse = fa.flash_attention_seg_with_lse(ql, kl, vl, seg)
            ro, rlse = fa.flash_attention_seg_plain(ql, kl, vl, seg)
            torch.cuda.synchronize()
            err, lerr = max_err(o, ro), _lse_err(torch, lse, rlse)
            assert err <= tol and lerr <= ltol, \
                f"flash seg {dtype} s={s} sp={sp} seg={seg}: max_abs_err " \
                f"{err} (lse {lerr})"
            key = f"{str(dtype)[6:]}"
            worst[key] = max(worst.get(key, 0.0), err)
        log(f"flash seg vs twin, {key}: {len(list(_seg_cases()))} "
            f"descriptors, worst max_abs_err {worst[key]:.3g}")
    # (2) the ring's pieces at the path's sequence, merged
    q, k, v, _ = _seg_qkv(torch, CP_SEQ, torch.bfloat16, seed=1)
    o_ref, lse_ref = fa.flash_attention_with_lse(q, k, v, True)
    ring_err = 0.0
    for sp in (2, 4):
        c = CP_SEQ // (2 * sp)
        for idx in range(sp):
            rq = _zigzag_rows(CP_SEQ, sp, idx)
            o_acc = torch.zeros(1, 2 * c, CP_HQ, CP_D, device="cuda")
            lse_acc = torch.full((1, CP_HQ, 2 * c), float("-inf"),
                                 device="cuda")
            for src in range(sp):
                rk = _zigzag_rows(CP_SEQ, sp, src)
                o_t, lse_t = fa.flash_attention_seg_with_lse(
                    q[:, rq], k[:, rk], v[:, rk], _zigzag_seg(idx, src, c, sp))
                o_acc, lse_acc = _merge(o_acc, lse_acc, o_t, lse_t)
            err = max_err(o_acc.bfloat16(), o_ref[:, rq])
            lerr = _lse_err(torch, lse_acc, lse_ref[:, :, rq])
            assert err <= 2e-2 and lerr <= 1e-4, \
                f"flash seg ring sp={sp} rank {idx}: merged pieces vs #1 " \
                f"max_abs_err {err} (lse {lerr})"
            ring_err = max(ring_err, err)
    log(f"flash seg ring check (global {CP_SEQ}, sp 2 and 4): merged pieces "
        f"vs #1 over the whole causal sequence, max_abs_err {ring_err:.3g}")
    del o_ref, lse_ref
    # (3) the path's t=0 descriptors against the twin at the path's shape,
    # one GQA group (2 q heads, 1 kv head) at a time: a group's fp32
    # scores are 2 GiB at 16384 rows, all 16 heads' 17 GB
    c = CP_SEQ // (2 * CP_SP)
    grp = CP_HQ // CP_HKV
    path_err = path_row = 0.0
    for idx in range(CP_SP):
        seg = _zigzag_seg(idx, idx, c, CP_SP)
        rq = _zigzag_rows(CP_SEQ, CP_SP, idx)
        ql, kl, vl = (x[:, rq].contiguous() for x in (q, k, v))
        o, lse = fa.flash_attention_seg_with_lse(ql, kl, vl, seg)
        for h in range(CP_HKV):
            qs = slice(grp * h, grp * (h + 1))
            ro, rlse = fa.flash_attention_seg_plain(
                ql[:, :, qs].contiguous(), kl[:, :, h:h + 1].contiguous(),
                vl[:, :, h:h + 1].contiguous(), seg)
            row = _row_scaled_err(torch, o[:, :, qs], ro)
            lerr = _lse_err(torch, lse[:, qs], rlse)
            assert row <= 2e-2 and lerr <= 1e-4, \
                f"flash seg at the path's shape, seg {seg}, kv head {h}: " \
                f"worst row error {row} of the row's max|twin| (lse {lerr})"
            path_err = max(path_err, max_err(o[:, :, qs], ro))
            path_row = max(path_row, row)
            del ro, rlse
        del o, lse
    log(f"flash seg vs twin at the path's shape (q [1, {2 * c}, 16, 64], "
        f"the t=0 descriptors of both ranks, per kv head): max_abs_err "
        f"{path_err:.3g}, worst row {path_row:.3g} x its max|twin| (limit "
        f"2e-2; lse 1e-4)")
    # (4) timed at the path's shape
    seg = _zigzag_seg(0, 0, c, CP_SP)
    rq = _zigzag_rows(CP_SEQ, CP_SP, 0)
    ql, kl, vl = (x[:, rq].contiguous() for x in (q, k, v))
    del q, k, v
    pairs = _live_pairs(torch, seg, 2 * c, 2 * c)
    flops = 4 * CP_D * CP_HQ * pairs
    nbytes = (2 * ql.numel() * 2 + 2 * kl.numel() * 2
              + CP_HQ * 2 * c * 4)
    b_ms, b_by = bound(nbytes, flops, "bf16")
    ms = timer.ms(lambda: fa.flash_attention_seg_with_lse(ql, kl, vl, seg))
    lib = _sdpa_seg_lib(torch, ql, kl, vl, seg)
    lib_ms = timer.ms(lambda: lib[0](*lib[1]), iters=3, warmup=1) \
        if lib else None
    del lib
    # the twin at a quarter of the path's rows: its fp32 scores at 16384
    # rows would take 17 GB a matrix
    pc = c // 4
    pq, pk, pv, _ = _seg_qkv(torch, 2 * pc, torch.bfloat16, seed=2)
    pseg = _zigzag_seg(0, 0, pc, CP_SP)
    plain = timer.ms(lambda: fa.flash_attention_seg_plain(pq, pk, pv, pseg),
                     iters=3, warmup=1)
    return dict(name="flash_attention_seg_fwd", route="cuda",
                source="paddle_tpu_torch/csrc/flash_attention_seg.cu",
                replaces="paddle_tpu/ops/pallas/flash_attention.py:458",
                path="train-cp", max_abs_err=max(max(worst.values()),
                                                 ring_err, path_err),
                tolerance="bf16 2e-2, fp32 2e-5 (lse 1e-4, 1e-5); at the "
                          "path's shape each row 2e-2 x its max|twin|; ring "
                          "pieces merged vs #1 2e-2",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, live_pairs=pairs,
                shape=f"bf16 q [1, {2 * c}, 16, 64], kv [1, {2 * c}, 8, 64], "
                      f"seg {seg} ({pairs} live pairs a head); plain at q "
                      f"[1, {2 * pc}, 16, 64], seg {pseg}")


def phase_flash_seg_bwd(torch, timer):
    """#4, the segment-causal backward: against its twin (bf16 and fp32,
    every descriptor of ``phase_flash_seg``, each launch twice, bitwise);
    the single-process ring check at global 32768, bf16: o and lse from
    #1 over the whole causal sequence (what the ring's merge gives each
    rank's rows), each (rank, source) piece of sp 2 and 4, dQ summed over
    the sources and dK/dV over the ranks in fp32, as the ring sums them,
    against #2; every (rank, source) descriptor of sp 2 against the twin
    at the path's shape, one kv head at a time; timed at that shape."""
    from paddle_tpu_torch.distributed.sequence_parallel import _zigzag_seg
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    worst = {}
    for dtype, rtol, atol in ((torch.bfloat16, 2e-2, 2e-2),
                              (torch.float32, 1e-4, 1e-5)):
        qkv = {}
        for s, sp, idx, src, seg in _seg_cases():
            if s not in qkv:
                qkv = {s: _seg_qkv(torch, s, dtype, seed=s)}
            q, k, v, do = qkv[s]
            rq, rk = _zigzag_rows(s, sp, idx), _zigzag_rows(s, sp, src)
            ql, kl, vl, dol = q[:, rq], k[:, rk], v[:, rk], do[:, rq]
            o, lse = fa.flash_attention_seg_plain(ql, kl, vl, seg)
            args = (ql, kl, vl, o.contiguous(), lse, dol, seg)
            got = fa.flash_attention_seg_bwd(*args)
            again = fa.flash_attention_seg_bwd(*args)
            want = fa.flash_attention_seg_bwd_plain(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                f"flash seg bwd {seg}: two launches on the same inputs differ"
            for name, a, c_ in zip(("dq", "dk", "dv"), got, want):
                assert a.dtype == c_.dtype, (name, a.dtype, c_.dtype)
                assert scaled_close(a, c_, rtol, atol), \
                    f"flash seg bwd {dtype} s={s} {seg} {name}: max_abs_err " \
                    f"{max_err(a, c_)} of max {float(c_.float().abs().max())}"
            key = f"{str(dtype)[6:]}"
            worst[key] = max(worst.get(key, 0.0),
                             max(max_err(a, c_) for a, c_ in zip(got, want)))
        log(f"flash seg bwd vs twin, {key}: {len(list(_seg_cases()))} "
            f"descriptors, bitwise repeats, worst max_abs_err "
            f"{worst[key]:.3g}")
    q, k, v, do = _seg_qkv(torch, CP_SEQ, torch.bfloat16, seed=3)
    o, lse = fa.flash_attention_with_lse(q, k, v, True)
    ref = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    ring_err = 0.0
    for sp in (2, 4):
        c = CP_SEQ // (2 * sp)
        rows = [_zigzag_rows(CP_SEQ, sp, r) for r in range(sp)]
        dq = [torch.zeros(1, 2 * c, CP_HQ, CP_D, device="cuda")
              for _ in range(sp)]
        dkv = [[torch.zeros(1, 2 * c, CP_HKV, CP_D, device="cuda")
                for _ in range(2)] for _ in range(sp)]
        for idx in range(sp):
            for src in range(sp):
                rq, rk = rows[idx], rows[src]
                g = fa.flash_attention_seg_bwd(
                    q[:, rq], k[:, rk], v[:, rk], o[:, rq], lse[:, :, rq],
                    do[:, rq], _zigzag_seg(idx, src, c, sp))
                dq[idx] += g[0].float()
                dkv[src][0] += g[1].float()
                dkv[src][1] += g[2].float()
        for r in range(sp):
            for name, got, want in (("dq", dq[r], ref[0][:, rows[r]]),
                                    ("dk", dkv[r][0], ref[1][:, rows[r]]),
                                    ("dv", dkv[r][1], ref[2][:, rows[r]])):
                assert scaled_close(got, want, 2e-2, 2e-2), \
                    f"flash seg bwd ring sp={sp} rank {r} {name}: summed " \
                    f"pieces vs #2 max_abs_err {max_err(got, want)} of max " \
                    f"{float(want.float().abs().max())}"
                ring_err = max(ring_err, max_err(got, want))
    log(f"flash seg bwd ring check (global {CP_SEQ}, sp 2 and 4): summed "
        f"pieces vs #2, max_abs_err {ring_err:.3g}")
    del ref
    # every (rank, source) descriptor of the path against the twin at the
    # path's shape, one GQA group at a time (its fp32 score-sized
    # intermediates are ~10 GiB at 16384 rows)
    c = CP_SEQ // (2 * CP_SP)
    grp = CP_HQ // CP_HKV
    path_err = 0.0
    for idx in range(CP_SP):
        for src in range(CP_SP):
            seg = _zigzag_seg(idx, src, c, CP_SP)
            rq = _zigzag_rows(CP_SEQ, CP_SP, idx)
            rk = _zigzag_rows(CP_SEQ, CP_SP, src)
            ql, kl, vl = q[:, rq], k[:, rk], v[:, rk]
            ol, lsel, dol = o[:, rq], lse[:, :, rq].contiguous(), do[:, rq]
            got = fa.flash_attention_seg_bwd(ql, kl, vl, ol, lsel, dol, seg)
            for h in range(CP_HKV):
                qs, ks = slice(grp * h, grp * (h + 1)), slice(h, h + 1)
                want = fa.flash_attention_seg_bwd_plain(
                    ql[:, :, qs].contiguous(), kl[:, :, ks].contiguous(),
                    vl[:, :, ks].contiguous(), ol[:, :, qs].contiguous(),
                    lsel[:, qs].contiguous(), dol[:, :, qs].contiguous(),
                    seg)
                for name, a, w in (("dq", got[0][:, :, qs], want[0]),
                                   ("dk", got[1][:, :, ks], want[1]),
                                   ("dv", got[2][:, :, ks], want[2])):
                    assert scaled_close(a, w, 2e-2, 2e-2), \
                        f"flash seg bwd at the path's shape, seg {seg}, kv " \
                        f"head {h} {name}: max_abs_err {max_err(a, w)} of " \
                        f"max {float(w.float().abs().max())}"
                    path_err = max(path_err, max_err(a, w))
                del want
            del got
    log(f"flash seg bwd vs twin at the path's shape (q [1, {2 * c}, 16, "
        f"64], every (rank, source) descriptor of sp 2, per kv head): "
        f"max_abs_err {path_err:.3g}")
    seg = _zigzag_seg(0, 0, c, CP_SP)
    rq = _zigzag_rows(CP_SEQ, CP_SP, 0)
    ql, kl, vl, dol = (x[:, rq].contiguous() for x in (q, k, v, do))
    del q, k, v, do, o, lse
    ol, lsel = fa.flash_attention_seg_with_lse(ql, kl, vl, seg)
    args = (ql, kl, vl, ol, lsel, dol, seg)
    pairs = _live_pairs(torch, seg, 2 * c, 2 * c)
    flops = 10 * CP_D * CP_HQ * pairs
    # reads q, o, dO, k, v and lse; writes dq, dk and dv
    nbytes = 4 * ql.numel() * 2 + 4 * kl.numel() * 2 + lsel.numel() * 4
    b_ms, b_by = bound(nbytes, flops, "bf16")
    ms = timer.ms(lambda: fa.flash_attention_seg_bwd(*args), iters=5)
    lib = _sdpa_seg_lib(torch, ql, kl, vl, seg)
    lib_ms = None
    if lib:
        lib_in = [t.detach().requires_grad_(True) for t in lib[1]]
        lib_out = lib[0](*lib_in)
        lib_ms = timer.ms(lambda: torch.autograd.grad(
            lib_out, lib_in, dol.transpose(1, 2), retain_graph=True),
            iters=3, warmup=1)
        del lib_in, lib_out
    del lib
    pc = c // 4
    pq, pk, pv, pdo = _seg_qkv(torch, 2 * pc, torch.bfloat16, seed=4)
    pseg = _zigzag_seg(0, 0, pc, CP_SP)
    po, plse = fa.flash_attention_seg_plain(pq, pk, pv, pseg)
    plain = timer.ms(lambda: fa.flash_attention_seg_bwd_plain(
        pq, pk, pv, po, plse, pdo, pseg), iters=3, warmup=1)
    return dict(name="flash_attention_seg_bwd", route="cuda",
                source="paddle_tpu_torch/csrc/flash_attention_seg.cu",
                replaces="paddle_tpu/ops/pallas/flash_attention.py:622",
                path="train-cp", max_abs_err=max(max(worst.values()),
                                                 ring_err, path_err),
                tolerance="bf16 rtol 2e-2, atol 2e-2 x max|twin| (at the "
                          "path's shape per kv head too); fp32 rtol 1e-4, "
                          "atol 1e-5 x max|twin|; bitwise repeat; ring sums "
                          "vs #2 at the bf16 tier",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, live_pairs=pairs,
                shape=f"bf16 q [1, {2 * c}, 16, 64], kv [1, {2 * c}, 8, 64], "
                      f"seg {seg}; plain at q [1, {2 * pc}, 16, 64], seg {pseg}")


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


# the MoE slice's shapes (bench.py:122-129): 8 x 2048 tokens routed top-2
# over 16 experts at capacity ceil(2 * 16384 / 16 * 2.0) = 4096, so the
# expert-major buffer has 65,536 rows; the counts hold 32,768 live rows
# with one empty and one full expert, as no drops leave them
MOE_HIDDEN, MOE_FFN, MOE_E, MOE_CPAD = 1024, 704, 16, 4096
MOE_COUNTS = [4096, 0] + [2048 + d for d in (
    -1501, 1501, -1003, 1003, -707, 707, -333, 333, -111, 111, -17, 17,
    1999, -1999)]
# the serving step's: <= 128 packed tokens, capacity 32, c_pad 64 (the
# kernels' row tile), 256 live rows
MOE_SERVE_CPAD = 64
MOE_SERVE_COUNTS = [32, 0] + [16 + d for d in (
    -9, 9, -5, 5, -16, 16, -3, 3, -1, 1, 0, 0, -7, 7)]


def expert_major(torch, width, counts, c_pad, dtype, std=1.0):
    """A ``[E * c_pad, width]`` buffer whose rows past each count are 0."""
    cnt = torch.tensor(counts, device="cuda")
    live = torch.arange(c_pad, device="cuda")[None, :] < cnt[:, None]
    x = torch.randn(len(counts) * c_pad, width, device="cuda") * std
    return (x * live.reshape(-1, 1)).to(dtype), cnt.to(torch.int32)


def grouped_mm_library(torch):
    """The PyTorch grouped GEMM used as a yardstick (never by the port):
    ``torch.nn.functional.grouped_mm`` where this torch has it, else
    ``torch._grouped_mm``; ``(None, None)`` when it has neither."""
    import torch.nn.functional as F
    for owner, name in ((F, "grouped_mm"), (torch, "_grouped_mm")):
        fn = getattr(owner, name, None)
        if fn is not None:
            return fn, f"{owner.__name__}.{name}"
    return None, None


def library_ms(torch, timer, fn, want, label):
    """``fn()``'s time, after checking it computes ``want`` (bf16 tier);
    None, with the reason logged, where the call is refused."""
    if fn is None:
        log(f"library {label}: no grouped GEMM in this torch")
        return None
    try:
        got = fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"library {label}: refused ({str(e).splitlines()[0][:120]})")
        return None
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    err = max(max_err(g, w) for g, w in zip(got, want))
    log(f"library {label}: max_abs_err against the kernel {err:.3g}")
    return timer.ms(fn)


def moe_offsets(torch, c_pad, e=MOE_E):
    """The library's group ends: multiples of c_pad (it has no ragged
    skip, so it computes the padding rows as well)."""
    return (torch.arange(1, e + 1, device="cuda") * c_pad).to(torch.int32)


def phase_gmm2(torch, timer):
    """Gate and up of the MoE training step: x bf16 [65536, 1024] (32,768
    live rows), w1/w2 bf16 [16, 1024, 704] at the init scale; and the
    serving step's fp32 buffer [1024, 1024] with bf16 weights."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, cnt = expert_major(torch, MOE_HIDDEN, MOE_COUNTS, MOE_CPAD,
                          torch.bfloat16)
    w1, w2 = ((torch.randn(MOE_E, MOE_HIDDEN, MOE_FFN, device="cuda")
               * 0.02).bfloat16() for _ in range(2))
    got = gg.gmm2(x, w1, w2, cnt)
    want = gg.gmm2_plain(x, w1, w2, cnt)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(got, want))
    for a, b in zip(got, want):
        assert torch.allclose(a.float(), b.float(), rtol=2e-2, atol=2e-2), \
            f"gmm2: max_abs_err {max_err(a, b)} beyond rtol/atol 2e-2"
    del want
    xs, cs = expert_major(torch, MOE_HIDDEN, MOE_SERVE_COUNTS, MOE_SERVE_CPAD,
                          torch.float32)
    sg = gg.gmm2(xs, w1, w2, cs)
    sw = gg.gmm2_plain(xs, w1, w2, cs)
    torch.cuda.synchronize()
    s_err = max(max_err(a, b) for a, b in zip(sg, sw))
    assert all(scaled_close(a, b, 1e-5, 1e-5) for a, b in zip(sg, sw)), \
        f"gmm2 fp32 serve shape: max_abs_err {s_err}"
    s_ms = timer.ms(lambda: gg.gmm2(xs, w1, w2, cs))
    s_plain = timer.ms(lambda: gg.gmm2_plain(xs, w1, w2, cs))
    s_bound = bound(w1.numel() * 2 * 2 + sum(MOE_SERVE_COUNTS) * MOE_HIDDEN
                    * 4 + 2 * xs.shape[0] * MOE_FFN * 4,
                    2 * 2 * sum(MOE_SERVE_COUNTS) * MOE_HIDDEN * MOE_FFN,
                    "fp32")
    log(f"gmm2 serve shape (fp32 x [1024, 1024], bf16 w): max_abs_err "
        f"{s_err:.3g}, {s_ms:.4f} ms, plain {s_plain:.4f} ms, bound "
        f"{s_bound[0]:.4f} ms ({s_bound[1]})")
    live = sum(MOE_COUNTS)
    flops = 2 * 2 * live * MOE_HIDDEN * MOE_FFN
    nbytes = (live * MOE_HIDDEN * 2 + 2 * w1.numel() * 2
              + 2 * x.shape[0] * MOE_FFN * 2)
    b_ms, b_by = bound(nbytes, flops, "bf16")
    # the unfused route (moe_fused_wi=False): two gmm launches on the same
    # inputs, each reading x
    unfused = (gg.gmm(x, w1, cnt), gg.gmm(x, w2, cnt))
    torch.cuda.synchronize()
    u_err = max(max_err(a, b) for a, b in zip(unfused, got))
    u_ms = timer.ms(lambda: (gg.gmm(x, w1, cnt), gg.gmm(x, w2, cnt)))
    log(f"gmm2 unfused (two gmm launches): max_abs_err against gmm2 "
        f"{u_err:.3g}, {u_ms:.4f} ms")
    del unfused
    fn, lib_name = grouped_mm_library(torch)
    offs = moe_offsets(torch, MOE_CPAD)
    lib = library_ms(torch, timer, fn and (lambda: (fn(x, w1, offs=offs),
                                                    fn(x, w2, offs=offs))),
                     got, f"{lib_name} x2 for gmm2")
    return dict(name="gmm2", route="cuda",
                source="paddle_tpu_torch/csrc/grouped_gemm.cu",
                replaces="paddle_tpu/ops/pallas/grouped_gemm.py:303",
                path="train-moe", counts=["gmm2"], max_abs_err=err,
                tolerance="rtol=atol=2e-2 (bf16 output); serve fp32 rtol "
                          "1e-5, atol 1e-5 x max|twin|",
                ms=timer.ms(lambda: gg.gmm2(x, w1, w2, cnt)),
                plain_ms=timer.ms(lambda: gg.gmm2_plain(x, w1, w2, cnt),
                                  iters=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library=f"{lib_name} (two calls)", unfused_ms=u_ms,
                unfused_max_abs_err=u_err, serve_ms=s_ms,
                serve_plain_ms=s_plain, serve_bound_ms=s_bound[0],
                serve_max_abs_err=s_err,
                shape="x bf16 [65536, 1024] (32768 live), w1/w2 bf16 "
                      "[16, 1024, 704]")


def phase_gmm(torch, timer):
    """The down projection (x bf16 [65536, 704] by [16, 704, 1024]), the dx
    of the gate projection (dy bf16 [65536, 704] by w[e]^T for w [16,
    1024, 704], read transposed; twice, bitwise) and the serving step's
    fp32 down projection over bf16 weights."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, cnt = expert_major(torch, MOE_FFN, MOE_COUNTS, MOE_CPAD,
                          torch.bfloat16)
    wd = (torch.randn(MOE_E, MOE_FFN, MOE_HIDDEN, device="cuda")
          * 0.02).bfloat16()
    out = gg.gmm(x, wd, cnt)
    ref = gg.gmm_plain(x, wd, cnt)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    assert torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-2), \
        f"gmm: max_abs_err {err} beyond rtol/atol 2e-2"
    del ref
    wg = (torch.randn(MOE_E, MOE_HIDDEN, MOE_FFN, device="cuda")
          * 0.02).bfloat16()
    dx = gg.gmm_t(x, wg, cnt)
    dx2 = gg.gmm_t(x, wg, cnt)
    rdx = gg.gmm_plain(x, wg, cnt, trans_w=True)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2), "gmm dx: two launches on the same inputs differ"
    dx_err = max_err(dx, rdx)
    assert torch.allclose(dx.float(), rdx.float(), rtol=2e-2, atol=2e-2), \
        f"gmm dx: max_abs_err {dx_err} beyond rtol/atol 2e-2"
    del rdx, dx2
    dx_ms = timer.ms(lambda: gg.gmm_t(x, wg, cnt))
    xs, cs = expert_major(torch, MOE_FFN, MOE_SERVE_COUNTS, MOE_SERVE_CPAD,
                          torch.float32)
    sg, sw = gg.gmm(xs, wd, cs), gg.gmm_plain(xs, wd, cs)
    torch.cuda.synchronize()
    s_err = max_err(sg, sw)
    assert scaled_close(sg, sw, 1e-5, 1e-5), \
        f"gmm fp32 serve shape: max_abs_err {s_err}"
    s_ms = timer.ms(lambda: gg.gmm(xs, wd, cs))
    log(f"gmm dx (trans_w) [65536, 704] by [16, 1024, 704]^T: max_abs_err "
        f"{dx_err:.3g}, bitwise on repeat, {dx_ms:.4f} ms; serve shape (fp32 "
        f"x [1024, 704], bf16 w): max_abs_err {s_err:.3g}, {s_ms:.4f} ms")
    live = sum(MOE_COUNTS)
    flops = 2 * live * MOE_FFN * MOE_HIDDEN
    nbytes = live * MOE_FFN * 2 + wd.numel() * 2 + x.shape[0] * MOE_HIDDEN * 2
    b_ms, b_by = bound(nbytes, flops, "bf16")
    fn, lib_name = grouped_mm_library(torch)
    offs = moe_offsets(torch, MOE_CPAD)
    lib = library_ms(torch, timer, fn and (lambda: fn(x, wd, offs=offs)),
                     out, f"{lib_name} for gmm")
    # the dx's library call reads w[e]^T as a transposed view, as the
    # kernel does
    wgt = wg.transpose(1, 2)
    dx_lib = library_ms(torch, timer, fn and (lambda: fn(x, wgt, offs=offs)),
                        dx, f"{lib_name} for the gmm dx")
    log(f"gmm dx: {dx_ms:.4f} ms beside {lib_name} {dx_lib} ms")
    return dict(name="gmm", route="cuda",
                source="paddle_tpu_torch/csrc/grouped_gemm.cu",
                replaces="paddle_tpu/ops/pallas/grouped_gemm.py:166",
                path="train-moe", counts=["gmm_fwd", "gmm_bwd"],
                max_abs_err=max(err, dx_err),
                tolerance="rtol=atol=2e-2 (bf16 output); dx bitwise on "
                          "repeat; serve fp32 rtol 1e-5, atol 1e-5 x "
                          "max|twin|",
                ms=timer.ms(lambda: gg.gmm(x, wd, cnt)),
                plain_ms=timer.ms(lambda: gg.gmm_plain(x, wd, cnt), iters=3,
                                  warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library=lib_name, dx_ms=dx_ms, dx_library_ms=dx_lib,
                serve_ms=s_ms,
                serve_max_abs_err=s_err,
                shape="x bf16 [65536, 704] (32768 live), w bf16 "
                      "[16, 704, 1024]")


def phase_tgmm(torch, timer):
    """The gate/up dW of the training step: x bf16 [65536, 1024] and dy
    bf16 [65536, 704], 32,768 live rows -> fp32 [16, 1024, 704]; twice,
    bitwise."""
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    x, cnt = expert_major(torch, MOE_HIDDEN, MOE_COUNTS, MOE_CPAD,
                          torch.bfloat16)
    dy, _ = expert_major(torch, MOE_FFN, MOE_COUNTS, MOE_CPAD,
                         torch.bfloat16)
    dw = gg.tgmm(x, dy, cnt)
    dw2 = gg.tgmm(x, dy, cnt)
    ref = gg.tgmm_plain(x, dy, cnt)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2), "tgmm: two launches on the same inputs differ"
    err = max_err(dw, ref)
    # fp32 sums over up to 4096 rows in another order
    assert scaled_close(dw, ref, 1e-4, 1e-5), f"tgmm: max_abs_err {err}"
    assert float(dw[1].abs().max()) == 0.0, "tgmm: the empty expert's dw"
    log(f"tgmm: max_abs_err {err:.4g} of max {float(ref.abs().max()):.4g}, "
        f"bitwise on repeat")
    del ref, dw2
    live = sum(MOE_COUNTS)
    flops = 2 * live * MOE_HIDDEN * MOE_FFN
    nbytes = live * (MOE_HIDDEN + MOE_FFN) * 2 + dw.numel() * 4
    b_ms, b_by = bound(nbytes, flops, "bf16")
    # the buffers are zero past each count, so one batched product over
    # the padded buffer computes the same fp32 dW; grouped_mm (bf16 out)
    # only where this torch's bmm has no out_dtype
    xe = x.view(MOE_E, MOE_CPAD, MOE_HIDDEN).transpose(1, 2)
    dye = dy.view(MOE_E, MOE_CPAD, MOE_FFN)
    lib_name = "torch.bmm(out_dtype=torch.float32)"
    lib = library_ms(torch, timer, lambda: torch.bmm(
        xe, dye, out_dtype=torch.float32), dw, f"{lib_name} for tgmm")
    if lib is None:
        fn, lib_name = grouped_mm_library(torch)
        lib_name = lib_name and f"{lib_name} (bf16 output)"
        offs = moe_offsets(torch, MOE_CPAD)
        lib = library_ms(torch, timer, fn and (
            lambda: fn(x.t(), dy, offs=offs)), dw, f"{lib_name} for tgmm")
    return dict(name="tgmm", route="cuda",
                source="paddle_tpu_torch/csrc/grouped_gemm.cu",
                replaces="paddle_tpu/ops/pallas/grouped_gemm.py:216",
                path="train-moe", counts=["tgmm"], max_abs_err=err,
                tolerance="rtol 1e-4, atol 1e-5 x max|twin|; bitwise repeat",
                ms=timer.ms(lambda: gg.tgmm(x, dy, cnt)),
                plain_ms=timer.ms(lambda: gg.tgmm_plain(x, dy, cnt), iters=3,
                                  warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                library=lib_name,
                shape="x bf16 [65536, 1024], dy bf16 [65536, 704] (32768 "
                      "live rows) -> fp32 [16, 1024, 704]")


def phase_scan(torch, timer):
    """The chunked SSD scan at serve-ssm's prefill (fp32 x [1, 1023, 64,
    32], d_state 16, chunk 128) and at ``bench_ssm_pretrain``'s widths
    (``bench.py:1899-1905``: bf16 x [4, 2048, 48, 64], d_state 64, chunk
    256), each against the chunked twin (y and the final state) and a
    second launch (bitwise). The kernel and the twin are timed on the
    padded operands the wrapper gives them."""
    from paddle_tpu_torch.ops.kernels import selective_scan as ss
    out = {}
    for tag, (b, l, h, dh, ds, dtype) in (
            ("serve", (1, 1023, 64, 32, 16, torch.float32)),
            ("train", (4, 2048, 48, 64, 64, torch.bfloat16))):
        x = torch.randn(b, l, h, dh, device="cuda").to(dtype)
        dt = torch.rand(b, l, h, device="cuda") * 0.1 + 0.01
        A = -torch.rand(h, device="cuda") - 0.1
        B = torch.randn(b, l, ds, device="cuda").to(dtype)
        C = torch.randn(b, l, ds, device="cuda").to(dtype)
        L = ss.resolve_chunk(l)
        lp = -(-l // L) * L
        la = torch.nn.functional.pad(dt * A, (0, 0, 0, lp - l))
        args = (torch.nn.functional.pad((dt[..., None] * x.float()).to(dtype),
                                        (0, 0, 0, 0, 0, lp - l)).contiguous(),
                la.transpose(1, 2).contiguous(),
                torch.nn.functional.pad(B, (0, 0, 0, lp - l)).contiguous(),
                torch.nn.functional.pad(C, (0, 0, 0, lp - l)).contiguous(), L)
        y, st = ss.scan_chunked(*args)
        y2, st2 = ss.scan_chunked(*args)
        ry, rst = ss._scan_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(st, st2), \
            f"scan {tag}: two launches on the same inputs differ"
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        err = max(max_err(y, ry), max_err(st, rst))
        for what, a, c in (("y", y, ry), ("state", st, rst)):
            log(f"scan {tag} {what}: max_abs_err {max_err(a, c):.4g} of max "
                f"{float(c.float().abs().max()):.4g}")
            assert scaled_close(a, c, tol, tol), f"scan {tag} {what}"
        # bytes: dtx, la, B, C read once, y and the state written once;
        # operations on the causal half of each chunk: C.B^T once per
        # (batch, chunk), the decays and M @ dtx per head, the carry's
        # two products per head
        esz = x.element_size()
        nbytes = (2 * b * l * h * dh * esz + b * h * l * 4
                  + 2 * b * l * ds * esz + b * h * ds * dh * 4)
        pairs = L * (L + 1) // 2
        flops = (lp // L) * (b * 2 * pairs * ds + b * h * (
            2 * pairs * dh + pairs + 4 * L * ds * dh))
        b_ms, b_by = bound(nbytes, flops,
                           "fp32" if dtype == torch.float32 else "bf16")
        out[tag] = dict(err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
                        ms=timer.ms(lambda: ss.scan_chunked(*args)),
                        plain_ms=timer.ms(lambda: ss._scan_reference(*args),
                                          iters=3, warmup=1),
                        blocks=b * h)
        log(f"scan {tag}: {b * h} blocks of the kernel on 132 SMs, "
            f"{out[tag]['ms']:.4f} ms, plain {out[tag]['plain_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        del x, y, y2, ry, args
        torch.cuda.empty_cache()
    s, t = out["serve"], out["train"]
    return dict(name="selective_scan", route="cuda",
                source="paddle_tpu_torch/csrc/selective_scan.cu",
                replaces="paddle_tpu/ops/pallas/selective_scan.py:172",
                path="serve-ssm", max_abs_err=max(s["err"], t["err"]),
                tolerance="fp32 rtol=atol=1e-5 x max|twin|, bf16 2e-2; "
                          "bitwise repeat",
                ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                bound_by=s["bound_by"], library_ms=None,
                library="none (no single PyTorch call computes the scan)",
                train_ms=t["ms"], train_plain_ms=t["plain_ms"],
                train_bound_ms=t["bound_ms"], train_bound_by=t["bound_by"],
                shape="fp32 x [1, 1023, 64, 32], d_state 16, chunk 128 "
                      "(train shape: bf16 x [4, 2048, 48, 64], d_state 64, "
                      "chunk 256)")


def phase_paged(torch, np, timer, rng):
    """Paged decode attention at the eager serve step (bf16 q [8, 32, 128]
    over Llama-3-8B pages, kv 8, block 64, the serve phase's prompt
    lengths 32..1024 plus 32 new tokens) and at the hybrid's (fp32 q [8,
    8, 128], kv 8, lengths 1023..1055), each against the twin."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    out = {}
    for tag, (hq, dtype, lens) in (
            ("eager", (32, torch.bfloat16,
                       [int(n) + 32
                        for n in np.linspace(32, 1024, 8).round()])),
            ("ssm", (8, torch.float32,
                     [int(n) for n in np.linspace(1023, 1055, 8).round()]))):
        hkv, d, bs, width = 8, 128, 64, 32
        need = [-(-n // bs) for n in lens]
        perm = rng.permutation(sum(need) + 8).astype("int32")
        tables = torch.zeros(8, width, dtype=torch.int32)
        off = 0
        for i, nb in enumerate(need):
            tables[i, :nb] = torch.from_numpy(perm[off:off + nb])
            off += nb
        nrows = (sum(need) + 8) * bs
        kc = torch.randn(nrows, hkv, d, device="cuda").to(dtype)
        vc = torch.randn(nrows, hkv, d, device="cuda").to(dtype)
        q = torch.randn(8, hq, d, device="cuda").to(dtype)
        args = (q, kc, vc, tables.cuda(),
                torch.tensor(lens, dtype=torch.int32, device="cuda"), bs)
        got = pa.paged_decode_attention(*args)
        want = pa.paged_decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if dtype == torch.float32:
            tol = 2e-5
            assert err <= tol, f"paged {tag}: max_abs_err {err} > {tol}"
        else:
            # a few bf16 ulps of each sequence's own scale: the long rows'
            # outputs are small, so an absolute 2e-2 would pass a key too
            # many or too few there
            row = [max_err(got[i], want[i]) / float(want[i].float().abs().max())
                   for i in range(len(lens))]
            tol = 2e-2
            assert max(row) <= tol, f"paged {tag}: per-row scaled err {row}"
            log(f"paged {tag}: worst sequence's max_abs_err over its "
                f"max|twin| {max(row):.3g} (limit {tol})")
        # bytes: each sequence's visible K/V rows once, q, out; flops 4*d
        # per (query head, key)
        esz = kc.element_size()
        nbytes = (sum(lens) * hkv * d * esz * 2 + 2 * q.numel() * esz
                  + 8 * (width + 1) * 4)
        flops = sum(lens) * hq * 4 * d
        b_ms, b_by = bound(nbytes, flops,
                           "fp32" if dtype == torch.float32 else "bf16")
        out[tag] = dict(err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
                        ms=timer.ms(lambda: pa.paged_decode_attention(*args)),
                        plain_ms=timer.ms(
                            lambda: pa.paged_decode_attention_plain(*args)))
        log(f"paged {tag}: max_abs_err {err:.3g}, {out[tag]['ms']:.4f} ms, "
            f"plain {out[tag]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), lengths {lens}")
    e, m = out["eager"], out["ssm"]
    return dict(name="paged_attention", route="cuda",
                source="paddle_tpu_torch/csrc/paged_attention.cu",
                replaces="paddle_tpu/ops/pallas/paged_attention.py:106",
                path="serve-eager", max_abs_err=max(e["err"], m["err"]),
                tolerance="bf16 2e-2 x each sequence's max|twin|, fp32 2e-5 "
                          "(max_abs)",
                ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
                bound_by=e["bound_by"], library_ms=None,
                ssm_ms=m["ms"], ssm_plain_ms=m["plain_ms"],
                ssm_bound_ms=m["bound_ms"], ssm_bound_by=m["bound_by"],
                shape="bf16 q [8, 32, 128] over bf16 pages (kv 8, block 64), "
                      "lengths 64..1056 (hybrid: fp32 q [8, 8, 128], "
                      "lengths 1023..1055)")


def phase_quant(torch, np, timer, rng):
    """Ragged paged attention over quantized pages (#10) against its twin:
    (a) #8's timing shape (fp32 q [72, 32, 128], kv 8, block 64) over int8
    pages; (b) the serve-quant step's shape (fp32 q [128, 16, 64], kv 8: 64
    decode rows of lengths up to 527 and a 64-token prompt chunk) over int8
    pages; (c) shape (a) over fp8 e4m3 pages; (d) shape (a) with a bf16 q
    and four pad tokens. Each twice, bitwise; pads exactly 0."""
    from paddle_tpu_torch.ops.kernels import quant as pq
    from paddle_tpu_torch.quantization import kv as kvq
    bs = 64

    def case(hq, hkv, d, rows, valids, seqs, width, mode, q_dtype):
        nblocks = seqs * width
        perm = torch.from_numpy(rng.permutation(nblocks).astype("int32"))
        tables = perm.reshape(seqs, width).cuda()
        kq, ks = kvq.quantize_kv(torch.randn(nblocks * bs, hkv, d,
                                             device="cuda"), mode)
        vq, vs = kvq.quantize_kv(torch.randn(nblocks * bs, hkv, d,
                                             device="cuda"), mode)
        t = len(rows)
        q = torch.randn(t, hq, d, device="cuda").to(q_dtype)
        args = (q, kq, vq, ks, vs, tables,
                torch.tensor(rows, dtype=torch.int32, device="cuda"),
                torch.tensor(valids, dtype=torch.int32, device="cuda"), bs)
        out = pq.ragged_paged_attention_quant(*args)
        again = pq.ragged_paged_attention_quant(*args)
        ref = pq.ragged_paged_attention_quant_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, again), "quant: two launches differ"
        err, top = max_err(out, ref), float(ref.float().abs().max())
        if q_dtype == torch.float32:
            # the scales fold into scores and weights in the kernel, into
            # the pages in the twin; sums in another order
            tol = 1e-4 * top
            assert err <= tol, f"quant {mode}: max_abs_err {err} > {tol}"
        else:
            tol = "rtol=atol=2e-2"
            assert torch.allclose(out.float(), ref.float(), rtol=2e-2,
                                  atol=2e-2), f"quant bf16: {err}"
        pads = [i for i, v in enumerate(valids) if v == 0]
        assert not pads or float(out[pads].abs().max()) == 0.0, \
            "quant: a pad token is not 0"
        # bytes: each visible page and its scale columns once, q read
        # once, out written once, rows/valids; flops 4*d per (query
        # head, key), as phase_ragged counts #8's
        blocks = {(row, j) for row, val in zip(rows, valids)
                  for j in range(-(-val // bs))}
        page = bs * hkv * d * 2 * kq.element_size() + bs * hkv * 4 * 2
        esz = q.element_size()
        nbytes = len(blocks) * page + q.numel() * esz * 2 + t * 8
        flops = sum(valids) * hq * 4 * d
        b_ms, b_by = bound(nbytes, flops, "fp32")
        res = dict(err=err, top=top, tol=tol, bound_ms=b_ms, bound_by=b_by,
                   ms=timer.ms(lambda: pq.ragged_paged_attention_quant(*args)),
                   plain_ms=timer.ms(
                       lambda: pq.ragged_paged_attention_quant_plain(*args)))
        log(f"quant {mode} q {str(q_dtype)[6:]} [{t}, {hq}, {d}]: max_abs_err "
            f"{err:.3g} of max {top:.3g} (tol {tol}), bitwise on repeat, "
            f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        return res

    a = case(32, 8, 128, RAGGED_ROWS, RAGGED_VALIDS, 8, 32, "int8",
             torch.float32)
    srs = np.random.RandomState(2)
    lens = srs.randint(1, 528, size=64).tolist()
    lens[17] = 527
    b = case(16, 8, 64, list(range(64)) + [64] * 64,
             lens + list(range(449, 513)), 65, 16, "int8", torch.float32)
    c = case(32, 8, 128, RAGGED_ROWS, RAGGED_VALIDS, 8, 32, "fp8",
             torch.float32)
    pad_valids = [0 if i in (3, 40, 70) else v
                  for i, v in enumerate(RAGGED_VALIDS)]
    dd = case(32, 8, 128, RAGGED_ROWS, pad_valids, 8, 32, "int8",
              torch.bfloat16)
    return dict(name="ragged_paged_attention_quant", route="cuda",
                source="paddle_tpu_torch/csrc/quant.cu",
                replaces="paddle_tpu/ops/pallas/quant.py:110",
                path="serve-quant",
                max_abs_err=max(a["err"], b["err"], c["err"], dd["err"]),
                tolerance="fp32 output 1e-4 x max|twin|, bf16 rtol=atol=2e-2;"
                          " bitwise repeat; pads exactly 0",
                ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                bound_by=a["bound_by"], library_ms=None,
                library="none (no single PyTorch call computes it)",
                serve_quant_ms=b["ms"], serve_quant_plain_ms=b["plain_ms"],
                serve_quant_bound_ms=b["bound_ms"],
                serve_quant_bound_by=b["bound_by"], fp8_ms=c["ms"],
                fp8_plain_ms=c["plain_ms"], fp8_bound_ms=c["bound_ms"],
                bf16_ms=dd["ms"], bf16_plain_ms=dd["plain_ms"],
                bf16_bound_ms=dd["bound_ms"],
                shape="(a) fp32 q [72, 32, 128] over int8 pages (kv 8, block "
                      "64), #8's lengths; (b) fp32 q [128, 16, 64] int8, "
                      "lengths up to 527; (c) (a) over fp8 pages; (d) (a) "
                      "with bf16 q and 4 pads")


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


def make_moe_requests(GenerationRequest, np, rng, vocab):
    """``bench_serve_llama_moe``'s traffic (``bench.py:1537-1545``): 16
    prompts of 64 tokens, 32 new tokens each, greedy but for the last 2,
    which sample (T 0.8, top-p 0.95)."""
    prompts = [rng.randint(0, vocab, 64).tolist() for _ in range(16)]
    reqs = [GenerationRequest(i, p, max_new_tokens=32) if i < 14 else
            GenerationRequest(i, p, max_new_tokens=32, temperature=0.8,
                              top_p=0.95, seed=1000 + i)
            for i, p in enumerate(prompts)]
    return prompts, reqs


def serve(torch, model, np, use_kernel=True, requests=make_requests,
          **engine_kw):
    """One engine run over the requests (the slice-1 set by default);
    returns outputs and a record of each step (wall seconds, prefill
    tokens, emitted tokens)."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    engine_kw = {"max_seqs": 8, "max_seq_len": 2048, "block_size": 64,
                 **engine_kw}
    eng = GenerationEngine(model, use_kernel=use_kernel, **engine_kw)
    prompts, reqs = requests(GenerationRequest, np, np.random.RandomState(0),
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
    for name in ("flash_attention_bwd", "rms_norm_bwd", "fused_block_fwd",
                 "gmm_fwd", "gmm_bwd", "gmm2", "tgmm", "paged_attention",
                 "selective_scan", "ragged_paged_attention_quant"):
        assert counts[name] == 0, counts
    for p, lg, d in zip(prompts, scored, out.values()):
        assert lg.shape == (1, len(p), cfg.vocab_size)
        assert bool(torch.isfinite(lg).all()), "non-finite logits"

    perf = serve_perf(eng, out, steps, wall, card)
    perf["kv_bytes_per_block"] = eng.cache.bytes_per_block
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
    agree = greedy_agreement(out, plain, range(6))
    log(f"serve: greedy agreement with the plain-twin engine {agree:.4f}")
    assert agree >= 0.99, f"greedy agreement {agree}"

    check_forward(torch, model, prompts[:3], scored[:3])
    return counts, perf, model, out


def phase_serve_eager(torch, np, model, layers, card, compiled):
    """The eager engine (``mode="eager"``) on the serve phase's model and
    requests: each prompt prefilled whole at admission through the model's
    layers (flash attention), then one Python layer walk per step with
    attention through the paged decode kernel, host sampling from one
    ``RandomState(0)``."""
    from paddle_tpu_torch.ops import kernels
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve-eager: the serve model ({layers} layers) and its 8 requests "
        f"through GenerationEngine(mode='eager')")

    # ---- the path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    cpu0 = time.process_time()
    eng, prompts, out, steps, wall = serve(torch, model, np, mode="eager")
    torch.cuda.synchronize()
    cpu = time.process_time() - cpu0
    counts = kernels.launch_counts()
    log(f"serve-eager: path launches {counts}")
    reasons = {rid: d["finish_reason"] for rid, d in out.items()}
    assert all(r == "length" for r in reasons.values()), reasons
    assert all(len(d["output_ids"]) == 32 for d in out.values())
    assert eng.cache.free_blocks == eng.cache.num_blocks, "page leak"
    n_steps = eng.stats["steps"]
    assert counts["paged_attention"] == n_steps * layers, (counts, n_steps)
    assert counts["flash_attention_fwd"] == len(prompts) * layers, counts
    assert counts["rms_norm_fwd"] == (len(prompts) + n_steps) * (
        2 * layers + 1), counts
    for name in ("ragged_paged_attention", "flash_attention_bwd",
                 "rms_norm_bwd", "fused_block_fwd", "gmm_fwd", "gmm_bwd",
                 "gmm2", "tgmm", "selective_scan",
                 "ragged_paged_attention_quant"):
        assert counts[name] == 0, (name, counts)
    perf = serve_perf(eng, out, steps, wall, card)
    perf["host_cpu_share"] = cpu / wall
    perf["greedy_agreement_compiled"] = greedy_agreement(out, compiled,
                                                         range(6))
    log("serve-eager: " + json.dumps(perf))
    del eng

    holder = {}

    def rerun():
        holder["out"], holder["wall"] = serve(torch, model, np,
                                              mode="eager")[2::2]
    rows, busy, pwall = device_profile(torch, rerun)
    perf["busy_share"] = report_profile("serve-eager", rows, busy, pwall,
                                        wall)
    assert holder["out"] == out, "serve-eager: second run differs"
    log("serve-eager: second run bitwise equal (greedy and seeded)")

    perf.update(check_eager_decode(torch, np, model, out))
    return counts, perf


# ------------------------------------------------------ serve-fleet phase
# the disaggregated fleet at the serve phase's widths and depth: one
# prefill host and two decode hosts, each its own process on the card
FLEET_ENGINE = {"max_seqs": 8, "max_seq_len": 2048, "block_size": 64}
# numerics of every host process, as this process runs: a fixed cuBLAS
# workspace (bitwise repeats), the serve phase's composed blocks (the hosts
# turn TF32 off themselves)
FLEET_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8",
             "FLAGS_pallas_fused_block": "off"}
FLEET_ROWS = 32768          # the path's largest record: 1024 tokens x 32


def fleet_spec(layers):
    """The hosts' spec in the reference's schema
    (``serve_host.py:64-92``): the serve phase's model (Llama-3-8B widths,
    seed 0) and engine."""
    cfg = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=layers, num_attention_heads=32,
               num_key_value_heads=8, max_position_embeddings=8192,
               rope_theta=500000.0, dtype="bfloat16")
    return {"model": "llama_tiny", "seed": 0, "device": "cuda",
            "config": cfg, "engine": dict(FLEET_ENGINE),
            "server": {"max_queue": 64}}


def fleet_requests(np, seed, tag, n=8):
    """``make_requests``' traffic from ``seed`` as ``(id, prompt, kwargs)``
    (a fresh ``GenerationRequest`` each time one is submitted)."""
    from paddle_tpu_torch.inference import GenerationRequest
    _, reqs = make_requests(GenerationRequest, np, np.random.RandomState(seed),
                            128256)
    return [(f"{tag}{r.request_id}", r.input_ids,
             dict(max_new_tokens=r.max_new_tokens, temperature=r.temperature,
                  top_p=r.top_p, seed=r.seed)) for r in reqs[:n]]


def _request(spec):
    from paddle_tpu_torch.inference import GenerationRequest
    rid, prompt, kw = spec
    return GenerationRequest(rid, list(prompt), **kw)


def fleet_baseline(torch, model, specs):
    """The one-process run: each request alone through a
    ``GenerationServer`` on the serve model, one after another."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationServer
    srv = GenerationServer(GenerationEngine(model, **FLEET_ENGINE))
    out = {}
    for spec in specs:
        h = srv.submit(_request(spec))
        assert srv.run_until_idle(), "baseline run did not finish"
        assert h.finish_reason == "length", h.finish_reason
        out[spec[0]] = list(h.output_ids)
    srv.close()
    del srv
    torch.cuda.empty_cache()
    return out


def _k18_rank(rank, work_dir):
    """#18 in one of two gloo ranks sharing the card (a ``["kv"]`` mesh):
    the path's largest record, bf16 K and V [32768, 8, 128] and an int8
    page segment with its fp32 scales [32768, 8], each moved from rank 0 to
    rank 1 by the kernel and by its twin (a gloo ``ppermute`` through the
    host), bit for bit; then the bf16 segment timed: the kernel's pull
    from rank 0's mapped slot and the library's ``Tensor.copy_`` of the
    same view by rank 1 alone on the card, then the twin and the whole SPMD
    call (stage, sync, barrier, pull) by both."""
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    from paddle_tpu_torch.ops.kernels import kv_handoff as k18
    dist.init_parallel_env(backend="gloo")
    mesh = dist.ProcessMesh([0, 1], ["kv"])
    dist.set_mesh(mesh)
    group, peer = mesh.group("kv"), 1 - rank

    def payload(r, shape, dtype):
        g = torch.Generator(device="cuda").manual_seed(200 + r)
        if dtype == torch.int8:
            return torch.randint(-128, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cases = [("K bf16", (FLEET_ROWS, 8, 128), torch.bfloat16),
             ("V bf16", (FLEET_ROWS, 8, 128), torch.bfloat16),
             ("K int8", (FLEET_ROWS, 8, 128), torch.int8),
             ("K scales fp32", (FLEET_ROWS, 8), torch.float32)]
    res = {"rank": rank, "checks": []}
    for label, shape, dtype in cases:
        x = payload(rank, shape, dtype)
        n0 = k18.launches
        got = k18.kv_pages_remote_copy(x, 0, 1, chunks=2, group=group)
        want = k18.kv_pages_remote_copy_plain(x, 0, 1, 2, group)
        torch.cuda.synchronize()
        res["checks"].append(dict(
            case=label, launches=k18.launches - n0,
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            equal_twin=torch.equal(got, want),
            equal_source=torch.equal(got, payload(peer, shape, dtype)),
            moved=not torch.equal(got, x)))
    # timing at the bf16 segment: the slot the last bf16 call staged stays
    # unwritten until both ranks pass the next call's barrier. Rank 1, the
    # destination, times the pull and the library's copy alone on the
    # card while rank 0 waits at a barrier
    x = payload(rank, cases[0][1], torch.bfloat16)
    got = k18.kv_pages_remote_copy(x, 0, 1, chunks=2, group=group)
    ring = hops._rings[group]
    theirs = ring.addr(peer, ring.slot ^ 1)
    nbytes = x.numel() * x.element_size()
    timer = Timer(torch)
    if rank == 1:
        out = torch.empty_like(x)
        res["ms"] = timer.ms(lambda: k18.pages_copy(out, theirs, 2))
        assert torch.equal(out, got)
        view = k18.device_view(theirs, nbytes, x.device).view(
            x.dtype).view(x.shape)
        res["library_ms"] = timer.ms(lambda: out.copy_(view))
    torch.distributed.barrier(group=group)
    res["plain_ms"] = timer.ms(lambda: k18.kv_pages_remote_copy_plain(
        x, 0, 1, 2, group), iters=3)
    res["call_ms"] = timer.ms(lambda: k18.kv_pages_remote_copy(
        x, 0, 1, chunks=2, group=group))
    res["bound_ms"], res["bound_by"] = bound(2 * nbytes, 0, "bf16")
    del timer
    torch.save(res, os.path.join(work_dir, f"k18_{rank}.pt"))


def _k18_check(torch, card):
    import tempfile
    import paddle_tpu_torch.distributed as dist
    with tempfile.TemporaryDirectory() as work:
        dist.spawn(_k18_rank, (work,), nprocs=2, timeout=600)
        ranks = [torch.load(os.path.join(work, f"k18_{r}.pt"))
                 for r in range(2)]
    for r in ranks:
        for c in r["checks"]:
            log(f"serve-fleet kernel kv_pages_remote_copy rank {r['rank']} "
                f"{c['case']}: " + json.dumps(c))
            assert c["equal_twin"] and c["moved"] and c["launches"] == 1, c
            # the ranks' pairing is a shift: rank 0 receives rank 1's too
            assert c["equal_source"], c
    r1 = dict(ranks[1], ranks=ranks)
    log(f"serve-fleet kernel kv_pages_remote_copy: bf16 [{FLEET_ROWS}, 8, "
        f"128] (64 MiB), rank 1 pulling rank 0's: kernel {r1['ms']:.4f} ms, "
        f"library copy_ {r1['library_ms']:.4f} ms, plain (gloo) "
        f"{r1['plain_ms']:.4f} ms, whole SPMD call {r1['call_ms']:.4f} ms, "
        f"bound {r1['bound_ms']:.4f} ms ({r1['bound_by']}) on {card}")
    return r1


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _leg_perf(handles, wall, card):
    """TTFT and end-to-end latency (router clocks, p50/p99, ms) and
    goodput (tokens of requests that finished ``length`` or ``eos`` per
    second of the leg's wall)."""
    ttft = [h.ttft_s * 1e3 for h in handles.values()]
    e2e = [h.e2e_s * 1e3 for h in handles.values()]
    good = sum(len(h.output_ids) for h in handles.values()
               if h.finish_reason in ("length", "eos"))
    return dict(requests=len(handles), wall_s=wall, ttft_ms_p50=_pct(ttft, .5),
                ttft_ms_p99=_pct(ttft, .99), e2e_ms_p50=_pct(e2e, .5),
                e2e_ms_p99=_pct(e2e, .99), goodput_tokens_per_s=good / wall,
                card=card)


def _fleet_state(sup):
    """Each live host's /introspect answer, and each proxy's wire time."""
    out = {}
    for name, h in sorted(sup.hosts.items()):
        if sup.procs[name].poll() is None:
            out[name] = dict(h.introspect(), transfer=dict(h.transfer))
    return out


def _delta(after, before, names):
    """Kernel launches and handoff counters between two states, summed
    over ``names`` (a host absent before counts from zero)."""
    launches, handoff, transfer = {}, {}, {}
    for n in names:
        a, b = after[n], before.get(n, {})
        for k, v in a["launches"].items():
            launches[k] = launches.get(k, 0) + v - b.get("launches", {}).get(
                k, 0)
        for k, v in a["handoff"].items():
            handoff[k] = handoff.get(k, 0) + v - b.get("handoff", {}).get(
                k, 0)
        for k, v in a["transfer"].items():
            transfer[k] = transfer.get(k, 0) + v - b.get(
                "transfer", {}).get(k, 0)
    return launches, handoff, transfer


def _split(pf, dc, tr, n):
    """The handoff's time split per record (ms): the prefill host's gather
    (into the IPC buffer on the device route) and pack, the transport, the
    decode host's install."""
    ms = lambda s: 1e3 * s / max(n, 1)          # noqa: E731
    return dict(handoffs=n, export_gather_ms=ms(pf["export_s"]),
                pack_ms=ms(pf["pack_s"]),
                transport_pull_ms=ms(dc["pull_s"]),
                transport_wire_ms=ms(tr["fetch_s"] + tr["push_s"]
                                     + dc["unpack_s"]),
                install_ms=ms(dc["install_s"]))


def _start_fleet(master, spec, use_kernels, log_dir):
    from paddle_tpu_torch.inference import FleetRouter, FleetSupervisor
    env = dict(FLEET_ENV, FLAGS_use_pallas_kernels="1" if use_kernels
               else "0")
    sup = FleetSupervisor(master.address, spec, log_dir=log_dir, env=env)
    router = FleetRouter(master_address=master.address)
    roles = (("pf0", "prefill"), ("dc0", "decode"), ("dc1", "decode"))
    for name, role in roles:
        sup.spawn(name, role, wait_ready=False)
    for name, _ in roles:
        router.register_host(sup.wait_ready(name))
    return sup, router


def _check_hosts(sup, digest, route):
    state = _fleet_state(sup)
    for name, s in state.items():
        assert s["digest"] == digest, \
            f"{name}: parameter digest {s['digest']} is not the baseline's"
        assert s["device"].startswith("cuda"), (name, s["device"])
        assert (s["ipc"] is not None) == (route == "ipc"), \
            (name, route, s["ipc"])
    return state


def _leak_free(state, names):
    for n in names:
        s = state[n]
        assert s["free_blocks"] == s["num_blocks"] and s["num_active"] == 0, \
            (n, "page leak", s["free_blocks"], s["num_blocks"])
        assert s["ipc_held"] == 0, (n, "IPC buffers still held",
                                    s["ipc_held"])


def _sequential_leg(router, specs, base, label):
    """Each request alone through the fleet, waited to completion; every
    stream bit for bit the one-process run's."""
    handles = {}
    t0 = time.perf_counter()
    for spec in specs:
        h = handles[spec[0]] = router.submit(_request(spec))
        assert router.run_until_idle(timeout_s=180.0, poll_s=0.005), \
            (label, router.stats())
        assert h.finish_reason == "length", (label, spec[0], h.finish_reason)
        assert h.output_ids == base[spec[0]], \
            (f"{label}: request {spec[0]}'s stream differs from the "
             f"one-process run", h.output_ids, base[spec[0]])
    return handles, time.perf_counter() - t0


def phase_serve_fleet(torch, np, layers, card, log_dir):
    """The disaggregated fleet (see the module docstring, phase 7)."""
    import signal
    from paddle_tpu_torch.distributed.launch.master import HTTPMaster
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    from paddle_tpu_torch.weights import param_digest
    t_phase = time.perf_counter()
    k18 = _k18_check(torch, card)
    segs = 2                            # bf16 pages: K and V a record

    # the one-process runs on the serve model rebuilt from its seed, which
    # then leaves this process before the hosts build theirs
    seq = fleet_requests(np, 0, "a")
    burst = fleet_requests(np, 1, "c")
    late = fleet_requests(np, 2, "d", n=3)
    model = LlamaForCausalLM(llama3_8b_config(dtype="bfloat16",
                                              num_hidden_layers=layers),
                             seed=0)
    base = fleet_baseline(torch, model, seq + burst + late)
    digest = param_digest(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve-fleet: one-process baselines done at "
        f"{time.perf_counter() - t_phase:.1f} s, parameter digest {digest}")
    spec = fleet_spec(layers)
    perf, counts = {"card": card}, {}
    master = HTTPMaster(ttl=60.0, serve_ttl=5.0, ops_hang_after=60.0,
                        ops_bundle_grace=0.5, ops_poll=0.05)
    try:
        # ---- (a) sequential handoffs, device to device through #18
        sup, router = _start_fleet(master, spec, True, log_dir)
        try:
            log(f"serve-fleet (a): 3 hosts ready at "
                f"{time.perf_counter() - t_phase:.1f} s")
            s0 = _check_hosts(sup, digest, "ipc")
            handles, wall = _sequential_leg(router, seq, base, "(a)")
            s1 = _fleet_state(sup)
            launches, ho, tr = _delta(s1, s0, s1)
            n = router.counters["handoffs"]
            assert n == len(seq), router.counters
            assert launches["kv_pages_remote_copy"] == n * segs, \
                (launches, n)
            assert ho["pulls"] == n and ho["installs"] == n, ho
            _leak_free(s1, s1)
            assert s1["pf0"]["ipc"]["released"] == n, s1["pf0"]["ipc"]
            counts["serve-fleet-a"] = launches
            perf["a"] = dict(_leg_perf(handles, wall, card),
                             **_split(ho, ho, tr, n))
            log("serve-fleet (a): 8 sequential requests equal to the "
                "one-process run bit for bit; " + json.dumps(perf["a"]))
        finally:
            router.close()
            sup.close()
        # ---- (b) the same over the serialized route
        sup, router = _start_fleet(master, spec, False, log_dir)
        try:
            s0 = _check_hosts(sup, digest, "bytes")
            handles, wall = _sequential_leg(router, seq, base, "(b)")
            s1 = _fleet_state(sup)
            launches, ho, tr = _delta(s1, s0, s1)
            n = router.counters["handoffs"]
            assert n == len(seq), router.counters
            assert launches["kv_pages_remote_copy"] == 0, launches
            assert ho["pulls"] == 0 and ho["installs"] == n \
                and ho["unpacks"] == n, ho
            _leak_free(s1, s1)
            counts["serve-fleet-serialized"] = launches
            perf["b"] = dict(_leg_perf(handles, wall, card),
                             **_split(ho, ho, tr, n))
            log("serve-fleet (b): the same 8 requests over packed bytes, "
                "equal to (a) bit for bit; " + json.dumps(perf["b"]))
        finally:
            router.close()
            sup.close()
        # ---- (c) concurrent traffic, a decode host SIGKILLed mid-stream
        sup, router = _start_fleet(master, spec, True, log_dir)
        try:
            s0 = _check_hosts(sup, digest, "ipc")
            t0 = time.perf_counter()
            handles = {s[0]: router.submit(_request(s)) for s in burst}
            seen = {rid: [] for rid in handles}

            def watch():
                for rid, h in handles.items():
                    now = h.output_ids
                    assert now[:len(seen[rid])] == seen[rid], \
                        f"(c): {rid}'s stream rewrote a streamed token"
                    seen[rid] = now
            deadline = time.monotonic() + 180.0
            mid = False
            while not mid:
                assert time.monotonic() < deadline, "dc1 never mid-stream"
                router.poll()
                watch()
                with router._lock:
                    mid = any(e.state == "decode" and e.host == "dc1"
                              and len(e.tokens) > 1
                              for e in router.journal.values())
                time.sleep(0.005)
            pre_kill = sup.hosts["dc1"].introspect()
            pre_kill["transfer"] = dict(sup.hosts["dc1"].transfer)
            sup.kill("dc1", signal.SIGKILL)
            while not router.run_until_idle(timeout_s=0.05, poll_s=0.005):
                watch()
                assert time.monotonic() < deadline, router.stats()
            watch()
            wall = time.perf_counter() - t0
            for rid, h in handles.items():
                assert h.finish_reason == "length" \
                    and len(h.output_ids) == 32, (rid, h.finish_reason,
                                                  len(h.output_ids))
                assert seen[rid] == h.output_ids == \
                    router.journal[rid].tokens, rid
            assert router.counters["failovers"] >= 1, router.counters
            s1 = _fleet_state(sup)
            _leak_free(s1, s1)
            dec = dict(s1, dc1=pre_kill)
            launches, ho, tr = _delta(dec, s0, dec)
            assert launches["kv_pages_remote_copy"] == ho["pulls"] * segs, \
                (launches, ho)
            # pf0 lives through the leg, so no pull may be refused: every
            # record pf0 staged was pulled and confirmed, or was dropped
            # unpulled because its decode host (dc1) died
            rc = router.counters
            ipc = {k: s1["pf0"]["ipc"][k] - s0["pf0"]["ipc"][k]
                   for k in ("staged", "released", "discarded")}
            assert ho["refused"] == 0 and rc["handoffs_refused"] == 0, \
                (ho, rc)
            assert ho["pulls"] <= ipc["released"], (ho, ipc)
            assert ipc["staged"] == rc["handoffs"] \
                == ipc["released"] + rc["handoffs_dropped"] \
                and ipc["discarded"] == rc["handoffs_dropped"], (ipc, rc)
            greedy = [s[0] for s in burst if not s[2]["temperature"]]
            agree = greedy_agreement(
                {r: {"output_ids": h.output_ids} for r, h in handles.items()},
                {r: {"output_ids": base[r]} for r in handles}, greedy)
            counts["serve-fleet-c"] = launches
            perf["c"] = dict(_leg_perf(handles, wall, card),
                             **_split(ho, ho, tr, router.counters["handoffs"]),
                             failovers=router.counters["failovers"],
                             greedy_agreement_one_process=agree,
                             pf0_ipc=s1["pf0"]["ipc"])
            mttr = None
            deadline = time.monotonic() + 60.0
            while mttr is None and time.monotonic() < deadline:
                done = master._incident_view()["incidents"]
                mttr = done[-1]["mttr_seconds"] if done else None
                time.sleep(0.05)
            assert mttr is not None and math.isfinite(mttr), \
                master._incident_view()
            perf["c"]["mttr_s"] = mttr
            log("serve-fleet (c): 8 concurrent requests, dc1 SIGKILLed "
                "mid-stream, every request 32 tokens, no token lost or "
                "repeated, no leak; " + json.dumps(perf["c"]))
            # ---- (d) recovery: two decode hosts again, the respawn serves
            assert sup.ensure(router=router) == ["dc1"]
            assert len(sup.live_hosts("decode")) == 2
            s0 = _check_hosts(sup, digest, "ipc")
            rc0 = dict(router.counters)
            landed = None
            for spec_d in late:
                handles, _ = _sequential_leg(router, [spec_d], base, "(d)")
                if handles[spec_d[0]].host == "dc1":
                    landed = spec_d[0]
                    break
            assert landed is not None, "no request landed on the respawn"
            s1 = _fleet_state(sup)
            launches, ho, tr = _delta(s1, s0, s1)
            n = router.counters["handoffs"] - rc0["handoffs"]
            assert launches["kv_pages_remote_copy"] == ho["pulls"] * segs \
                and ho["pulls"] == ho["installs"] == n >= 1 \
                and ho["refused"] == 0, (launches, ho, n)
            assert router.counters["handoffs_refused"] \
                == rc0["handoffs_refused"], router.counters
            _leak_free(s1, s1)
            counts["serve-fleet-d"] = launches
            perf["d"] = dict(request=landed, pulls=ho["pulls"])
            log(f"serve-fleet (d): dc1 respawned, request {landed} served on "
                f"it bit for bit equal to the one-process run")
        finally:
            router.close()
            sup.close()
    finally:
        master.shutdown()
    path = {}
    for leg in ("serve-fleet-a", "serve-fleet-c", "serve-fleet-d"):
        for k, v in counts.pop(leg).items():
            path[k] = path.get(k, 0) + v
    counts["serve-fleet"] = path
    log("serve-fleet: path launches (legs a, c, d, the decode and prefill "
        "hosts) " + json.dumps(path))
    row = dict(name="kv_pages_remote_copy", route="cuda",
               source="paddle_tpu_torch/csrc/kv_handoff.cu",
               replaces="paddle_tpu/inference/kv_handoff.py:393",
               path="serve-fleet", tolerance="bitwise",
               max_abs_err=max(c["max_abs_err"] for r in k18["ranks"]
                               for c in r["checks"]),
               ms=k18["ms"], call_ms=k18["call_ms"], plain_ms=k18["plain_ms"],
               bound_ms=k18["bound_ms"], bound_by=k18["bound_by"],
               library_ms=k18["library_ms"],
               shape=f"bf16 [{FLEET_ROWS}, 8, 128] (a 1024-token record's K "
                     f"at 32 layers), rank 1 of 2 on one card pulling rank "
                     f"0's slot; plain: a gloo ppermute through the host; "
                     f"library: Tensor.copy_ from the mapped slot")
    perf["k18_call_ms"] = k18["call_ms"]
    log(f"serve-fleet: {time.perf_counter() - t_phase:.1f} s")
    return counts, row, perf


def teacher_forced(torch, np, model, out, **engine_kw):
    """The eager engine over the serve requests, fed the tokens of ``out``
    (teacher forcing): the logits row behind each greedy request's
    tokens, fp32 numpy, by request."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    eng = GenerationEngine(model, mode="eager", max_seqs=8, max_seq_len=2048,
                           block_size=64, **engine_kw)
    rows = {rid: [] for rid in range(6)}

    def forced(req, arr):
        if req.request_id in rows:
            rows[req.request_id].append(arr.copy())
        return out[req.request_id]["output_ids"][len(req.output_ids)]
    eng._sample_host = forced
    _, reqs = make_requests(GenerationRequest, np, np.random.RandomState(0),
                            model.config.vocab_size)
    eng.generate(reqs)
    return np.concatenate([np.stack(r) for r in rows.values()])


def check_eager_decode(torch, np, model, out):
    """The eager path's logits through the kernels, through every plain
    twin, and through the twins on an fp32 copy (``exact``), each engine
    fed the kernel run's tokens so that one flip does not carry into the
    rest of a stream. As ``check_forward`` does for the forward: the
    kernels' logits are no further from ``exact`` than 1.25x the twins'
    (relative L2 over the 6 greedy streams), and no further from the
    twins' than the twins' are from ``exact`` (the kernels move the logits
    less than bf16 rounding alone does; 0.0414 against 0.0610 on the H100).
    Reports the share of steps whose greedy token each of the other two
    would have chosen too."""
    kern = teacher_forced(torch, np, model, out)
    with plain_twins():
        twin = teacher_forced(torch, np, model, out, use_kernel=False)
        model32 = fp32_copy(model)
        model32.config.dtype = "float32"       # fp32 pages too
        exact = teacher_forced(torch, np, model32, out, use_kernel=False)
    del model32
    torch.cuda.empty_cache()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    tokens = kern.argmax(-1)
    res = dict(eager_rel_err_kernel=rel(kern, exact),
               eager_rel_err_twin=rel(twin, exact),
               eager_rel_err_kernel_vs_twin=rel(kern, twin),
               greedy_agreement_twins_forced=float(
                   (twin.argmax(-1) == tokens).mean()),
               greedy_agreement_fp32_forced=float(
                   (exact.argmax(-1) == tokens).mean()))
    msg = (f"serve-eager: teacher-forced logits over {len(tokens)} steps: rel "
           f"err vs fp32 kernel {res['eager_rel_err_kernel']:.4g}, twin "
           f"{res['eager_rel_err_twin']:.4g}, kernel vs twin "
           f"{res['eager_rel_err_kernel_vs_twin']:.4g}; greedy tokens the "
           f"twins would choose too {res['greedy_agreement_twins_forced']:.4f}"
           f", the fp32 copy {res['greedy_agreement_fp32_forced']:.4f}")
    log(msg)
    assert res["eager_rel_err_kernel"] <= 1.25 * res[
        "eager_rel_err_twin"] + 1e-6, msg
    assert res["eager_rel_err_kernel_vs_twin"] <= res[
        "eager_rel_err_twin"], msg
    return res


# bench_serve_ssm's on-chip configuration and traffic (bench.py:1972-2078)
SSM_WIDTH = dict(hidden_size=1024, intermediate_size=2816,
                 num_attention_heads=8, num_key_value_heads=8,
                 vocab_size=32000, max_position_embeddings=4096)
SSM_LAYERS, SSM_PROMPT, SSM_NEW, SSM_BLOCK = 8, 1023, 32, 64
SSM_POOL_BLOCKS, SSM_MAX_SEQS = 128, 64


def _pool_bytes(cache) -> int:
    """Bytes of a cache's K and V pages (the pads' spare row left out)."""
    return sum(t.numel() * t.element_size()
               for li in range(cache.num_layers) for t in cache.layer(li)[:2])


def _hybrid_engine(model, num_blocks, mode, use_kernel=True):
    from paddle_tpu_torch.inference import GenerationEngine
    return GenerationEngine(
        model, max_seqs=SSM_MAX_SEQS,
        max_seq_len=SSM_PROMPT + SSM_NEW + SSM_BLOCK, block_size=SSM_BLOCK,
        num_blocks=num_blocks, mode=mode, use_kernel=use_kernel)


def _ssm_requests(np, tag):
    from paddle_tpu_torch.inference import GenerationRequest
    rs = np.random.RandomState(7)
    return [GenerationRequest((tag, i), rs.randint(0, 64, SSM_PROMPT).tolist(),
                              max_new_tokens=SSM_NEW) for i in range(8)]


def phase_serve_ssm(torch, np, card):
    """``bench_serve_ssm`` on the card: the hybrid (vocab 32000, hidden
    1024, ffn 2816, 8 layers "SA", 8:8 heads of 128, d_state 16, SSM head
    dim 32: d_inner 2048, 64 SSM heads, conv 4; fp32, seeded random
    weights), the equal-byte admission headline, then 8 greedy requests of
    1023-token prompts and 32 new tokens through the compiled and the
    eager engine, each after a warm run."""
    from paddle_tpu_torch.models import (HybridSSMForCausalLM,
                                         LlamaForCausalLM, llama_tiny_config,
                                         ssm_tiny_config)
    from paddle_tpu_torch.inference import GenerationRequest
    from paddle_tpu_torch.ops import kernels
    gc.collect()
    torch.cuda.empty_cache()
    hy_cfg = ssm_tiny_config(num_hidden_layers=SSM_LAYERS, ssm_state_size=16,
                             ssm_head_dim=32, layer_pattern="SA", **SSM_WIDTH)
    at_cfg = llama_tiny_config(num_hidden_layers=SSM_LAYERS, **SSM_WIDTH)
    hy_model = HybridSSMForCausalLM(hy_cfg, seed=0).eval()
    at_model = LlamaForCausalLM(at_cfg, seed=0).eval()
    n_ssm = hy_cfg.resolved_pattern().count("S")
    n_attn = SSM_LAYERS - n_ssm
    log(f"serve-ssm: hybrid {hy_cfg.resolved_pattern()} (hidden 1024, ffn "
        f"2816, 8:8 heads of 128, d_inner {hy_cfg.ssm_d_inner}, "
        f"{hy_cfg.ssm_num_heads} SSM heads of 32, d_state 16), fp32, "
        f"{sum(p.numel() for p in hy_model.parameters()) / 1e6:.1f}M "
        f"parameters")

    # -- the equal-byte admission headline
    rs = np.random.RandomState(0)
    at_eng = _hybrid_engine(at_model, SSM_POOL_BLOCKS, "compiled")
    pool = _pool_bytes(at_eng.cache)
    per_block = (2 * n_attn * SSM_BLOCK * hy_cfg.num_key_value_heads
                 * hy_cfg.head_dim * 4)
    hy_blocks = pool // per_block
    hy_eng = _hybrid_engine(hy_model, hy_blocks, "compiled")
    assert _pool_bytes(hy_eng.cache) <= pool

    def admissions(eng):
        n = 0
        while n < SSM_MAX_SEQS and eng.add_request(GenerationRequest(
                ("adm", n), rs.randint(0, 64, SSM_PROMPT).tolist(),
                max_new_tokens=SSM_NEW)):
            n += 1
        return n
    at_adm, hy_adm = admissions(at_eng), admissions(hy_eng)
    ratio = hy_adm / max(1, at_adm)
    perf = dict(admission_ratio=ratio, admitted_hybrid=hy_adm,
                admitted_attention=at_adm, pool_bytes=pool,
                hybrid_blocks=hy_blocks,
                ssm_state_bytes=hy_eng.ssm_state_bytes(), card=card)
    log(f"serve-ssm: equal {pool} B pools admit {hy_adm} hybrid and "
        f"{at_adm} attention-only {SSM_PROMPT}-token prompts ({ratio:.2f}x), "
        f"+{hy_eng.ssm_state_bytes()} B of SSM state")
    assert ratio >= 2.0, perf
    del at_eng, hy_eng, at_model
    gc.collect()
    torch.cuda.empty_cache()

    # -- greedy requests through both modes, each after a warm run
    counts, outs = {}, {}
    for mode in ("compiled", "eager"):
        eng = _hybrid_engine(hy_model, hy_blocks, mode)
        eng.generate(_ssm_requests(np, "warm"))
        st0 = dict(eng.stats)
        # ---- the path: counts zeroed just before, read just after
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.generate(_ssm_requests(np, "run"), return_details=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts[mode] = kernels.launch_counts()
        log(f"serve-ssm {mode}: path launches {c}")
        steps = eng.stats["steps"] - st0["steps"]
        step_s = eng.stats["step_time_s"] - st0["step_time_s"]
        emitted = eng.stats["decode_tokens"] - st0["decode_tokens"]
        assert all(d["finish_reason"] == "length"
                   and len(d["output_ids"]) == SSM_NEW for d in out.values())
        assert c["selective_scan"] == 8 * n_ssm, c
        assert c["flash_attention_fwd"] == 8 * n_attn, c
        attn = ("ragged_paged_attention" if mode == "compiled"
                else "paged_attention")
        other = ("paged_attention" if mode == "compiled"
                 else "ragged_paged_attention")
        assert c[attn] == steps * n_attn and c[other] == 0, (c, steps)
        for name in ("flash_attention_bwd", "rms_norm_bwd", "fused_block_fwd",
                     "gmm_fwd", "gmm_bwd", "gmm2", "tgmm",
                     "ragged_paged_attention_quant"):
            assert c[name] == 0, (name, c)
        check_drained(eng)
        perf[mode] = dict(
            steps=steps, decode_ms_per_step=1e3 * step_s / steps,
            decode_tokens_per_s=(emitted - 8) / step_s,
            tokens_per_s_generate=emitted / wall, generate_s=wall)
        log(f"serve-ssm {mode}: " + json.dumps(perf[mode]))

        holder = {}

        def rerun():
            holder["out"] = eng.generate(_ssm_requests(np, "run"),
                                         return_details=True)
        rows, busy, pwall = device_profile(torch, rerun)
        perf[mode]["busy_share"] = report_profile(f"serve-ssm {mode}", rows,
                                                  busy, pwall, wall)
        assert holder["out"] == out, f"serve-ssm {mode}: profiled repeat"
        check_drained(eng)
        del eng
        with plain_twins():
            twin = _hybrid_engine(hy_model, hy_blocks, mode,
                                  use_kernel=False).generate(
                _ssm_requests(np, "run"), return_details=True)
        perf[mode]["greedy_agreement_twins"] = greedy_agreement(
            out, twin, out.keys())
        log(f"serve-ssm {mode}: profiled repeat bitwise equal; greedy "
            f"agreement with the plain-twin engine "
            f"{perf[mode]['greedy_agreement_twins']:.4f}")
        assert perf[mode]["greedy_agreement_twins"] >= 0.99, perf[mode]
        outs[mode] = out
    agree = greedy_agreement(outs["compiled"], outs["eager"],
                             outs["compiled"].keys())
    perf["compiled_vs_eager"] = agree
    log(f"serve-ssm: compiled tokens equal to eager's {agree:.4f} "
        f"(the reference asserts 1.0)")
    assert agree >= 0.99, agree
    both = {k: counts["compiled"][k] + counts["eager"][k]
            for k in counts["compiled"]}
    del hy_model
    torch.cuda.empty_cache()
    return both, perf


def phase_serve_int8(torch, np, model, layers, card, bf16, compiled):
    """The serve phase once more with ``kv_quant="int8"``: the same 8B-width
    model and requests over int8 pages, attention through #10 at head_dim
    128 in every layer. ``bf16`` is the serve phase's perf, ``compiled``
    its outputs."""
    from paddle_tpu_torch.ops import kernels
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve-int8: the serve model ({layers} layers) and its 8 requests "
        f"through GenerationEngine(kv_quant='int8')")

    # ---- the path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    cpu0 = time.process_time()
    eng, _, out, steps, wall = serve(torch, model, np, kv_quant="int8")
    torch.cuda.synchronize()
    cpu = time.process_time() - cpu0
    counts = kernels.launch_counts()
    log(f"serve-int8: path launches {counts}")
    assert eng.kv_quant == "int8" and eng.cache.k.dtype == torch.int8
    assert all(d["finish_reason"] == "length" and len(d["output_ids"]) == 32
               for d in out.values()), out
    assert eng.cache.free_blocks == eng.cache.num_blocks, "page leak"
    n_steps = eng.stats["steps"]
    assert counts["ragged_paged_attention_quant"] == n_steps * layers, \
        (counts, n_steps)
    for name in kernels.KERNELS:
        if name != "ragged_paged_attention_quant":
            assert counts[name] == 0, (name, counts)
    perf = serve_perf(eng, out, steps, wall, card)
    perf["host_cpu_share"] = cpu / wall
    perf["kv_bytes_per_block"] = eng.cache.bytes_per_block
    del eng
    _, _, twin, _, _ = serve(torch, model, np, use_kernel=False,
                             kv_quant="int8")
    perf["greedy_agreement_twins"] = greedy_agreement(out, twin, range(6))
    # not asserted: 32 bf16 layers of random weights (see PERF.md, PR 4)
    perf["greedy_agreement_bf16_pages"] = greedy_agreement(out, compiled,
                                                           range(6))
    log(f"serve-int8: decode {perf['decode_ms_per_step']:.2f} ms per step, "
        f"{perf['decode_tokens_per_s']:.1f} decode tokens/s, "
        f"{perf['output_tokens_per_s']:.1f} output tokens/s (bf16 pages: "
        f"{bf16['decode_ms_per_step']:.2f} ms, "
        f"{bf16['decode_tokens_per_s']:.1f}, "
        f"{bf16['output_tokens_per_s']:.1f}); {perf['kv_bytes_per_block']} "
        f"B a block against {bf16['kv_bytes_per_block']}; greedy agreement "
        f"with the twins {perf['greedy_agreement_twins']:.4f}, with the "
        f"bf16-page run {perf['greedy_agreement_bf16_pages']:.4f}")
    log("serve-int8: " + json.dumps(perf))
    assert perf["greedy_agreement_twins"] >= 0.99, perf
    return counts, perf


# bench_serve_llama_quant's on-chip configuration and traffic
# (bench.py:1758-1884), nothing cut
QUANT_WIDTH = dict(hidden_size=1024, intermediate_size=2816,
                   num_attention_heads=16, num_key_value_heads=8,
                   vocab_size=32000, max_position_embeddings=2048)
QUANT_LAYERS, QUANT_PROMPT, QUANT_NEW, QUANT_BLOCK = 8, 511, 16, 64
QUANT_POOL_BLOCKS, QUANT_MAX_SEQS = 128, 64


def make_quant_requests(GenerationRequest, np, rng, vocab):
    """``bench_serve_llama_quant``'s parity traffic: 8 greedy 511-token
    prompts (``RandomState(7)``, ids below 64), 16 new tokens each."""
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 64, QUANT_PROMPT).tolist() for _ in range(8)]
    return prompts, [GenerationRequest(("run", i), p,
                                       max_new_tokens=QUANT_NEW)
                     for i, p in enumerate(prompts)]


QUANT_ENGINE = dict(max_seqs=QUANT_MAX_SEQS,
                    max_seq_len=QUANT_PROMPT + QUANT_NEW + QUANT_BLOCK,
                    block_size=QUANT_BLOCK, mode="compiled")


def _quant_serve(torch, model, np, num_blocks, **kw):
    return serve(torch, model, np, requests=make_quant_requests,
                 num_blocks=num_blocks, **QUANT_ENGINE, **kw)


def forced_logits(torch, np, model, ref, num_blocks, **kw):
    """The engine fed ``ref``'s tokens (teacher forcing) over the quant
    requests: at every greedy step, its own choice and the logits row it
    chose from, given the reference's prefix, in ``ref``'s (request,
    position) order. Free-running streams cannot tell one near-tie flip
    from many: a flip changes every later token of its stream."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    from paddle_tpu_torch.inference import decode_step as ds
    eng = GenerationEngine(model, num_blocks=num_blocks, **QUANT_ENGINE, **kw)
    last, rec = {}, {}
    plan, emit, sample = eng._plan_step, eng._emit_token, ds.sample_tokens

    def planned():
        last["entries"] = plan()
        return last["entries"]

    def sampled(logits, *rest):
        last["logits"] = logits
        return sample(logits, *rest)

    def forced(req, tok):     # rows follow the step's entries
        row = [e[0] for e in last["entries"]].index(req)
        rec.setdefault(req.request_id, []).append(
            (tok, last["logits"][row].float().cpu()))
        return emit(req, ref[req.request_id]["output_ids"][len(req.output_ids)])
    eng._plan_step, eng._emit_token = planned, forced
    ds.sample_tokens = sampled
    try:
        eng.generate(make_quant_requests(GenerationRequest, np, None, None)[1])
    finally:
        ds.sample_tokens = sample
    assert eng.cache.free_blocks == eng.cache.num_blocks, "page leak"
    choices = np.array([t for rid in ref for t, _ in rec[rid]])
    logits = torch.stack([lg for rid in ref for _, lg in rec[rid]]).numpy()
    return choices, logits


def check_quant_logits(torch, np, model, fp_out, q_blocks, perf):
    """Top-1 agreement with the unquantized stream, judged with every engine
    fed that stream's tokens: the unquantized engine itself, the int8
    engine through the kernel (``kern``) and through the plain twins
    (``twin``), the same quantized pages. Relative L2 over the logits rows
    of all greedy steps: the int8 pages move the logits less than the bf16
    tier (2e-2), the kernel moves them no further than 1.25x the twins do,
    and kernel and twin are closer to each other than either is to the
    unquantized logits. The top-1 agreement is reported."""
    fp_tok, fp = forced_logits(torch, np, model, fp_out, QUANT_POOL_BLOCKS)
    want = np.array([t for d in fp_out.values() for t in d["output_ids"]])
    assert (fp_tok == want).all(), "unquantized engine fed its own stream"
    k_tok, kern = forced_logits(torch, np, model, fp_out, q_blocks,
                                kv_quant="int8")
    _, twin = forced_logits(torch, np, model, fp_out, q_blocks,
                            kv_quant="int8", use_kernel=False)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    res = dict(top1_agreement=float((k_tok == want).mean()),
               logits_rel_err_kernel=rel(kern, fp),
               logits_rel_err_twin=rel(twin, fp),
               logits_rel_err_kernel_vs_twin=rel(kern, twin))
    msg = (f"serve-quant: fed the unquantized stream's tokens over "
           f"{len(want)} steps: int8 top-1 agreement "
           f"{res['top1_agreement']:.4f}; logits rel err vs unquantized "
           f"kernel {res['logits_rel_err_kernel']:.4g}, twin "
           f"{res['logits_rel_err_twin']:.4g}, kernel vs twin "
           f"{res['logits_rel_err_kernel_vs_twin']:.4g}")
    log(msg)
    assert res["logits_rel_err_twin"] <= 2e-2, msg
    assert res["logits_rel_err_kernel"] <= 1.25 * res[
        "logits_rel_err_twin"] + 1e-6, msg
    assert res["logits_rel_err_kernel_vs_twin"] <= res[
        "logits_rel_err_twin"], msg
    perf.update(res)
    w_tok, wq = forced_logits(torch, np, model, fp_out, q_blocks,
                              kv_quant="int8", weight_quant=True)
    perf["weight_quant_top1_agreement"] = float((w_tok == want).mean())
    perf["weight_quant_logits_rel_err"] = rel(wq, fp)
    log(f"serve-quant: with weight-only int8 too, fed the same tokens: top-1 "
        f"agreement {perf['weight_quant_top1_agreement']:.4f}, logits rel "
        f"err vs unquantized {perf['weight_quant_logits_rel_err']:.4g} (not "
        f"asserted)")


def phase_serve_quant(torch, np, card):
    """``bench_serve_llama_quant`` on the card: the equal-byte admission
    headline (a bf16 engine at 128 blocks against an int8 one sized by
    ``bytes_per_block``), then its 8 greedy requests through an fp32 copy
    (seed 0), unquantized and over int8 pages, and the int8 engine with
    weight-only int8 too."""
    from paddle_tpu_torch.inference import GenerationEngine, GenerationRequest
    from paddle_tpu_torch.inference.paged_cache import PagedKVCache
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.ops import kernels
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_tiny_config(num_hidden_layers=QUANT_LAYERS, dtype="bfloat16",
                            **QUANT_WIDTH)
    model = LlamaForCausalLM(cfg, seed=0).eval()
    log(f"serve-quant: bench_serve_llama_quant (8 layers, hidden 1024, ffn "
        f"2816, 16:8 heads of {cfg.head_dim}, vocab 32000), bf16, seeded "
        f"random weights")

    # -- the equal-byte admission headline
    def engine(num_blocks, kv_quant):
        return GenerationEngine(
            model, max_seqs=QUANT_MAX_SEQS,
            max_seq_len=QUANT_PROMPT + QUANT_NEW + QUANT_BLOCK,
            block_size=QUANT_BLOCK, num_blocks=num_blocks, mode="compiled",
            kv_quant=kv_quant)
    fp_eng = engine(QUANT_POOL_BLOCKS, None)
    pool = QUANT_POOL_BLOCKS * fp_eng.cache.bytes_per_block
    probe = PagedKVCache(QUANT_LAYERS, 1, QUANT_BLOCK,
                         cfg.num_key_value_heads, cfg.head_dim, 1,
                         quant="int8")
    q_blocks = pool // probe.bytes_per_block
    q_eng = engine(q_blocks, "int8")
    assert q_eng.cache.quant == "int8"
    assert q_blocks * q_eng.cache.bytes_per_block <= pool
    rs = np.random.RandomState(0)

    def admissions(eng):
        n = 0
        while n < QUANT_MAX_SEQS and eng.add_request(GenerationRequest(
                ("adm", n), rs.randint(0, 64, QUANT_PROMPT).tolist(),
                max_new_tokens=QUANT_NEW)):
            n += 1
        return n
    fp_adm, q_adm = admissions(fp_eng), admissions(q_eng)
    ratio = q_adm / max(1, fp_adm)
    def row(cache):      # bytes a token row costs in one layer
        return cache.bytes_per_block // (QUANT_BLOCK * QUANT_LAYERS)
    perf = dict(admission_ratio=ratio, admitted_int8=q_adm,
                admitted_bf16=fp_adm, pool_bytes=pool, int8_blocks=q_blocks,
                row_bytes_bf16=row(fp_eng.cache), row_bytes_int8=row(
                    q_eng.cache), card=card)
    log(f"serve-quant: equal {pool} B pools ({QUANT_POOL_BLOCKS} bf16 blocks, "
        f"{q_blocks} int8 blocks; {perf['row_bytes_int8']} against "
        f"{perf['row_bytes_bf16']} B a row and layer) admit {q_adm} int8 and "
        f"{fp_adm} bf16 {QUANT_PROMPT}-token prompts ({ratio:.3f}x)")
    assert ratio >= 1.8, perf
    del fp_eng, q_eng, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- greedy parity on an fp32 copy (seed 0), as the bench runs it
    cfg32 = llama_tiny_config(num_hidden_layers=QUANT_LAYERS,
                              dtype="float32", **QUANT_WIDTH)
    model = LlamaForCausalLM(cfg32, seed=0).eval()
    fp_eng, _, fp_out, fp_steps, fp_wall = _quant_serve(
        torch, model, np, QUANT_POOL_BLOCKS)
    assert fp_eng.cache.free_blocks == fp_eng.cache.num_blocks, "page leak"
    perf["unquantized"] = serve_perf(fp_eng, fp_out, fp_steps, fp_wall, card)
    del fp_eng

    # ---- the path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    cpu0 = time.process_time()
    eng, _, out, steps, wall = _quant_serve(torch, model, np, q_blocks,
                                            kv_quant="int8")
    torch.cuda.synchronize()
    cpu = time.process_time() - cpu0
    counts = kernels.launch_counts()
    log(f"serve-quant: path launches {counts}")
    assert all(d["finish_reason"] == "length"
               and len(d["output_ids"]) == QUANT_NEW for d in out.values())
    assert eng.cache.free_blocks == eng.cache.num_blocks, "page leak"
    n_steps = eng.stats["steps"]
    assert counts["ragged_paged_attention_quant"] == n_steps * QUANT_LAYERS, \
        (counts, n_steps)
    assert counts["ragged_paged_attention"] == 0, counts
    for name in kernels.KERNELS:
        if name != "ragged_paged_attention_quant":
            assert counts[name] == 0, (name, counts)
    perf["int8"] = serve_perf(eng, out, steps, wall, card)
    perf["int8"]["host_cpu_share"] = cpu / wall
    del eng
    # free-running agreement with the unquantized stream, reported: one
    # near-tie flip on random weights derails the rest of a stream
    # (check_quant_logits judges the steps one by one)
    perf["top1_agreement_free_running"] = greedy_agreement(out, fp_out,
                                                           out.keys())

    # a profiled repeat, bitwise
    holder = {}

    def rerun():
        holder["out"], holder["wall"] = _quant_serve(
            torch, model, np, q_blocks, kv_quant="int8")[2::2]
    rows, busy, pwall = device_profile(torch, rerun)
    perf["int8"]["busy_share"] = report_profile("serve-quant", rows, busy,
                                                pwall, wall)
    assert holder["out"] == out, "serve-quant: profiled repeat differs"

    _, _, twin, _, _ = _quant_serve(torch, model, np, q_blocks,
                                    kv_quant="int8", use_kernel=False)
    perf["greedy_agreement_twins"] = greedy_agreement(out, twin, out.keys())
    perf["top1_agreement_free_running_twins"] = greedy_agreement(
        twin, fp_out, twin.keys())
    assert perf["greedy_agreement_twins"] >= 0.99, perf
    check_quant_logits(torch, np, model, fp_out, q_blocks, perf)

    # int8 pages and weight-only int8 together
    weng, _, wout, wsteps, wwall = _quant_serve(
        torch, model, np, q_blocks, kv_quant="int8", weight_quant=True)
    assert weng.weight_quant and weng.cache.free_blocks == \
        weng.cache.num_blocks
    perf["int8_weight_int8"] = serve_perf(weng, wout, wsteps, wwall, card)
    del weng
    _, _, wtwin, _, _ = _quant_serve(torch, model, np, q_blocks,
                                     kv_quant="int8", weight_quant=True,
                                     use_kernel=False)
    perf["weight_quant_agreement_twins"] = greedy_agreement(wout, wtwin,
                                                            wout.keys())
    perf["weight_quant_top1_agreement_free_running"] = greedy_agreement(
        wout, fp_out, wout.keys())
    log(f"serve-quant: profiled repeat bitwise equal; free-running greedy "
        f"agreement of the int8 engine with the twins "
        f"{perf['greedy_agreement_twins']:.4f}, with the unquantized stream "
        f"{perf['top1_agreement_free_running']:.4f} (twins "
        f"{perf['top1_agreement_free_running_twins']:.4f}); with weight-only "
        f"int8 too: with the twins "
        f"{perf['weight_quant_agreement_twins']:.4f}, with the unquantized "
        f"stream {perf['weight_quant_top1_agreement_free_running']:.4f} "
        f"(not asserted)")
    assert perf["weight_quant_agreement_twins"] >= 0.99, perf
    log("serve-quant: " + json.dumps(perf))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, perf


def check_drained(eng):
    """No page leak, and every slot's conv and SSM state zero (the pads'
    spare row past ``max_seqs`` is no slot's)."""
    assert eng.cache.free_blocks == eng.cache.num_blocks, "page leak"
    for st in eng._sstate:
        if st is not None:
            for name, t in st.items():
                assert float(t[:eng.max_seqs].abs().sum()) == 0.0, \
                    f"{name} state left after the drain"


def serve_perf(eng, out, steps, wall, card):
    """Steps, decode-only steps (their rows, tokens/s and ms), output
    tokens/s of the whole ``generate``."""
    decode = [(dt, n) for dt, pre, n in steps if pre == 0]
    dec_tok = sum(n for _, n in decode)
    dec_s = sum(dt for dt, _ in decode)
    total_tok = sum(len(d["output_ids"]) for d in out.values())
    return dict(steps=eng.stats["steps"], decode_only_steps=len(decode),
                decode_rows_per_step=dec_tok / len(decode) if decode
                else None,
                decode_tokens_per_s=dec_tok / dec_s if dec_s else None,
                decode_ms_per_step=1e3 * dec_s / len(decode)
                if decode else None,
                generate_s=wall, output_tokens_per_s=total_tok / wall,
                prefill_tokens=eng.stats["prefill_tokens"], card=card)


def greedy_agreement(out, plain, ids):
    same = total = 0
    for rid in ids:
        a, b = out[rid]["output_ids"], plain[rid]["output_ids"]
        same += sum(x == y for x, y in zip(a, b))
        total += len(a)
    return same / total


def phase_serve_moe(torch, np, card):
    """The slice-3 serving path: the MoE training configuration (fresh
    seeded weights, eval) through ``GenerationEngine(max_seqs=16,
    max_seq_len=160, block_size=64)`` with ``bench_serve_llama_moe``'s
    traffic."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    # the serve phase's engine and 8B model sit in reference cycles
    gc.collect()
    torch.cuda.empty_cache()
    flags.set_flags({"pallas_fused_block": "auto", "moe_fused_wi": True})
    cfg = moe_config()
    layers = cfg.num_hidden_layers
    log(f"serve-moe: the train-moe configuration ({layers} layers, 16 "
        f"experts, top-2 gshard, cf 2.0, bf16), seeded random weights; 16 "
        f"prompts of 64 tokens, 32 new tokens each, 2 sampled")
    model = LlamaForCausalLM(cfg, seed=1).eval()
    kw = dict(requests=make_moe_requests, max_seqs=16, max_seq_len=160,
              block_size=64)

    # ---- the path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    cpu0 = time.process_time()
    eng, prompts, out, steps, wall = serve(torch, model, np, **kw)
    torch.cuda.synchronize()
    cpu = time.process_time() - cpu0
    counts = kernels.launch_counts()
    log(f"serve-moe: path launches {counts}")
    reasons = {rid: d["finish_reason"] for rid, d in out.items()}
    assert all(r == "length" for r in reasons.values()), reasons
    assert all(len(d["output_ids"]) == 32 for d in out.values())
    assert eng.cache.free_blocks == eng.cache.num_blocks, "page leak"
    n_steps = eng.stats["steps"]
    for name in ("ragged_paged_attention", "gmm2", "gmm_fwd"):
        assert counts[name] == n_steps * layers, (name, counts, n_steps)
    for name in ("gmm_bwd", "tgmm", "flash_attention_fwd",
                 "flash_attention_bwd", "rms_norm_fwd", "rms_norm_bwd",
                 "fused_block_fwd", "paged_attention", "selective_scan",
                 "ragged_paged_attention_quant"):
        assert counts[name] == 0, (name, counts)
    perf = serve_perf(eng, out, steps, wall, card)
    # the step is issued op by op from Python: the host's CPU time over
    # the wall says how far the host, not the card, sets the step time
    perf["host_cpu_share"] = cpu / wall
    log("serve-moe: " + json.dumps(perf))

    # a second timed run of the same engine, then a third under the
    # profiler: both must give the first run's streams bitwise
    cpu0 = time.process_time()
    eng2, _, out2, steps2, wall2 = serve(torch, model, np, **kw)
    again = serve_perf(eng2, out2, steps2, wall2, card)
    log(f"serve-moe: second timed run: decode "
        f"{again['decode_ms_per_step']:.2f} ms per step, "
        f"{again['output_tokens_per_s']:.1f} output tokens/s, host cpu "
        f"share {(time.process_time() - cpu0) / wall2:.3f}")
    assert out2 == out, "serve-moe: second run differs"
    perf["decode_ms_per_step_second_run"] = again["decode_ms_per_step"]
    del eng2

    holder = {}

    def rerun():
        holder["out"], holder["wall"] = serve(torch, model, np, **kw)[2::2]
    rows, busy, pwall = device_profile(torch, rerun)
    perf["busy_share"] = report_profile("serve-moe", rows, busy, pwall, wall)
    launched = sum(n for _, n, _ in rows)
    log(f"serve-moe profile: {launched} device kernels in {n_steps} steps "
        f"({launched / n_steps:.0f} a step)")
    assert holder["out"] == out, "serve-moe: profiled run differs"
    log("serve-moe: second and third runs bitwise equal (greedy and "
        "seeded)")

    _, _, plain, _, _ = serve(torch, model, np, use_kernel=False, **kw)
    agree = greedy_agreement(out, plain, range(14))
    log(f"serve-moe: greedy agreement with the plain-twin engine "
        f"{agree:.4f}")
    assert agree >= 0.99, f"serve-moe greedy agreement {agree}"
    perf["greedy_agreement"] = agree

    # the unfused expert MLP (moe_fused_wi=False): gate and up as two gmm
    # launches where the fused route launches one gmm2
    flags.set_flags({"moe_fused_wi": False})
    try:
        kernels.reset_launch_counts()
        ueng, _, uout, usteps, uwall = serve(torch, model, np, **kw)
        torch.cuda.synchronize()
        ucounts = kernels.launch_counts()
    finally:
        flags.set_flags({"moe_fused_wi": True})
    u_steps = ueng.stats["steps"]
    log(f"serve-moe unfused: path launches {ucounts}")
    assert ueng.cache.free_blocks == ueng.cache.num_blocks, "page leak"
    assert ucounts["gmm2"] == 0, ucounts
    assert ucounts["gmm_fwd"] == u_steps * layers * 3, (ucounts, u_steps)
    assert ucounts["ragged_paged_attention"] == u_steps * layers, ucounts
    perf["unfused"] = serve_perf(ueng, uout, usteps, uwall, card)
    perf["unfused"]["greedy_agreement_fused"] = greedy_agreement(
        uout, out, range(14))
    log(f"serve-moe unfused: decode "
        f"{perf['unfused']['decode_ms_per_step']:.2f} ms per step (fused "
        f"{perf['decode_ms_per_step']:.2f}), greedy tokens equal to the "
        f"fused run's {perf['unfused']['greedy_agreement_fused']:.4f}")
    assert perf["unfused"]["greedy_agreement_fused"] >= 0.99, perf
    del model, eng, ueng
    torch.cuda.empty_cache()
    return counts, perf, ucounts


@contextlib.contextmanager
def plain_twins():
    """Every kernel wrapper the model calls goes to its plain twin inside
    the block (a reference, never a fallback)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_block as fb
    from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels import selective_scan as ss
    patches = [(fa, "flash_attention_with_lse", fa.flash_attention_plain),
               (fa, "flash_attention_bwd", fa.flash_attention_bwd_plain),
               (fa, "flash_attention_seg_with_lse",
                fa.flash_attention_seg_plain),
               (fa, "flash_attention_seg_bwd",
                fa.flash_attention_seg_bwd_plain),
               (rn, "rms_norm", rn.rms_norm_plain),
               (rn, "rms_norm_bwd", rn.rms_norm_bwd_plain),
               (fb, "fused_block", fb.fused_block_plain),
               (gg, "gmm", gg.gmm_plain), (gg, "gmm2", gg.gmm2_plain),
               (gg, "gmm_t", lambda dy, w, c: gg.gmm_plain(dy, w, c, True)),
               (gg, "tgmm", gg.tgmm_plain),
               (pa, "paged_decode_attention", pa.paged_decode_attention_plain),
               (ss, "scan_chunked", ss._scan_reference)]
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
        model32 = fp32_copy(model)
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


def build_trainer(torch, cfg, prepare=None):
    """``_llama_run``'s model, optimizer and step (``bench.py:62-90``);
    ``prepare(model)`` runs before the optimizer is built (placing the
    parameters over a mesh)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, seed=0)
    if prepare is not None:
        prepare(model)
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


def fp32_copy(model):
    """An fp32 deep copy of ``model``. The MoE gates' aux loss of the last
    forward (a tensor inside that forward's graph, which cannot be deep
    copied) is dropped first."""
    from paddle_tpu_torch.incubate.distributed.models.moe import BaseGate
    for m in model.modules():
        if isinstance(m, BaseGate):
            m._loss = None
    return copy.deepcopy(model).float()


@contextlib.contextmanager
def recorded_routes(model):
    """Inside the block, every MoE gate of ``model`` appends its expert
    choices ``[tokens, k]`` to the returned list, layer by layer."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    routes = []
    gates = [m.gate for m in model.modules() if isinstance(m, MoELayer)]
    for g in gates:
        inner = type(g).route_indices.__get__(g)

        def record(*a, _inner=inner, **kw):
            out = _inner(*a, **kw)
            routes.append(out[0].detach().clone())
            return out
        g.route_indices = record
    try:
        yield routes
    finally:
        for g in gates:
            del g.route_indices


def check_train_step(torch, model, ids):
    """One step's loss and gradients from the model's current weights
    through the kernels, through the plain twins, and through the twins
    on an fp32 copy (``exact``): the losses agree at the bf16 tier, the
    kernel gradients (relative L2 over all parameters) are no further
    from ``exact`` than 1.25x the twin gradients are, and no parameter's
    kernel gradient is further from ``exact`` than 1.5x its twin
    gradient. For an MoE model it also reports the share of (token, k)
    routes of the kernel run that the fp32 copy's routing takes too."""
    with recorded_routes(model) as routes_k:
        loss_k, g_k = loss_and_grads(torch, model, ids)
    with plain_twins():
        loss_t, g_t = loss_and_grads(torch, model, ids)
        model32 = fp32_copy(model)
        with recorded_routes(model32) as routes_e:
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
    res = dict(loss_kernel=loss_k, loss_twin=loss_t, loss_fp32=loss_e,
               grad_rel_l2_kernel=r_k, grad_rel_l2_twin=r_t,
               worst_param_ratio=worst[0])
    if routes_k:
        agree = [float((a == b).float().mean())
                 for a, b in zip(routes_k, routes_e)]
        res["route_agreement_fp32"] = sum(agree) / len(agree)
        msg += (f"; (token, k) routes equal to the fp32 copy's: "
                f"{res['route_agreement_fp32']:.5f} (by layer "
                f"{[round(a, 5) for a in agree]})")
    log(msg)
    assert abs(loss_k - loss_t) <= 2e-2 * abs(loss_t) + 2e-2, msg
    assert r_k <= 1.25 * r_t + 1e-6, msg
    # per parameter too, so that a fault confined to a few layers'
    # gradients is not diluted by the large embedding and head gradients
    assert worst[0] <= 1.5, msg
    return res


def run_train(torch, np, card, label, cfg, batch, seq, steps, want,
              flops_per_token, warmup=2):
    """``bench.py:_llama_run``'s loop for ``cfg``: warmup + 1 steps, then
    ``steps`` timed steps with the launch counts zeroed just before and
    read just after (``want``: launches per step of each kernel), a
    profiled repeat of 2 steps, one step's gradients against the twins
    and an fp32 copy, and a second run from the seed, bitwise."""
    from paddle_tpu_torch.ops import kernels
    # the engines of earlier phases sit in reference cycles (a timed step
    # closes over its engine): free them, so that this phase's memory is
    # its own
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True, warn_only=True)
    model, opt, train_step = build_trainer(torch, cfg)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, size=(batch, seq))
                           .astype("int32")).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{label}: {n_params / 1e6:.1f}M parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup + 1):
        losses.append(train_step(ids))
    torch.cuda.synchronize()
    log(f"{label}: {warmup + 1} warmup steps in "
        f"{time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # ---- the path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(train_step(ids))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"{label}: path launches {counts}")
    for name in kernels.KERNELS:
        assert counts[name] == want.get(name, 0) * steps, (name, counts)

    vals = [float(x) for x in losses]
    log(f"{label}: losses {vals}")
    assert all(math.isfinite(x) for x in vals), "non-finite loss"
    assert vals[-1] < vals[0], "the loss on the fixed batch did not fall"

    tps = batch * seq * steps / dt
    perf = dict(tokens_per_s=tps, ms_per_step=1e3 * dt / steps,
                mfu=tps * flops_per_token(n_params) / PEAK_FLOPS["bf16"],
                steps=steps, n_params=n_params, loss_first=vals[0],
                loss_last=vals[-1],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                card=card)
    log(f"{label}: " + json.dumps(perf))

    rows, busy, pwall = device_profile(
        torch, lambda: [train_step(ids) for _ in range(2)])
    perf["busy_share"] = report_profile(label, rows, busy, pwall,
                                        2 * dt / steps, top=15)

    perf.update(check_train_step(torch, model, ids))

    # a second run from the seed repeats the first steps bitwise
    first = losses[:warmup + 1]
    del model, opt, train_step
    torch.cuda.empty_cache()
    model, opt, train_step = build_trainer(torch, cfg)
    again = [train_step(ids) for _ in range(len(first))]
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"{label}: second run from the seed, {len(first)} steps: "
        f"{'bitwise equal' if same else 'DIFFERS'} "
        f"({[float(x) for x in again]})")
    assert same, "a second run from the seed differs"
    del model, opt, train_step
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return counts, perf


def phase_train(torch, np, card):
    import paddle_tpu_torch as paddle
    paddle.flags.set_flags({"pallas_fused_block": "auto"})
    layers, cfg = TRAIN_LAYERS, flagship_config()
    log(f"train: flagship Llama (bench.py:2315: vocab 32000, hidden 1536, "
        f"ffn 4096, GQA 12:4, head_dim 128), {layers} layers, bf16, "
        f"batch {TRAIN_B} x seq {TRAIN_S}, AdamW(lr 1e-4, wd 0.1), seeded "
        f"random weights, pallas_fused_block=auto")
    want = dict(fused_block_fwd=layers, flash_attention_fwd=layers,
                flash_attention_bwd=layers, rms_norm_fwd=2 * layers + 1,
                rms_norm_bwd=2 * layers + 1)
    return run_train(
        torch, np, card, "train", cfg, TRAIN_B, TRAIN_S, TRAIN_STEPS, want,
        lambda n: 6 * n + 12 * layers * cfg.hidden_size * TRAIN_S)


# the MoE training configuration (bench.py:122-129)
MOE_B, MOE_S, MOE_LAYERS = 8, 2048, 6


def moe_config():
    """``bench_moe``'s on-chip config: DeepSeekMoE/Qwen2-MoE proportions,
    16 experts of ffn 704, top-2 gshard at capacity factor 2.0."""
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=MOE_HIDDEN,
                       intermediate_size=MOE_FFN,
                       num_hidden_layers=MOE_LAYERS, num_attention_heads=16,
                       num_key_value_heads=16, max_position_embeddings=2048,
                       dtype="bfloat16", recompute=False,
                       moe_num_experts=MOE_E, moe_gate="gshard",
                       moe_capacity_factor=2.0, moe_aux_weight=0.01)


def phase_train_moe(torch, np, card):
    """The slice-3 training path: the MoE Llama at full width, 2+1 warmup
    and 10 timed AdamW steps. MFU is ``bench_moe``'s activated-parameter
    formula (``bench.py:139-145``) against 989 TFLOP/s bf16."""
    import paddle_tpu_torch as paddle
    paddle.flags.set_flags({"pallas_fused_block": "auto",
                            "moe_fused_wi": True})
    cfg = moe_config()
    layers, e = cfg.num_hidden_layers, cfg.moe_num_experts
    log(f"train-moe: bench_moe (bench.py:122: vocab 32000, hidden 1024, "
        f"16 experts of ffn 704, top-2 gshard, cf 2.0, 16:16 heads, "
        f"head_dim 64), {layers} layers, bf16, batch {MOE_B} x seq {MOE_S}, "
        f"AdamW(lr 1e-4, wd 0.1), seeded random weights")
    # per layer: gmm2 and the down gmm forward; the dx of the down gmm and
    # two of gmm2 (gmm against w^T); three tgmm for the dW
    want = dict(gmm2=layers, gmm_fwd=layers, gmm_bwd=3 * layers,
                tgmm=3 * layers, flash_attention_fwd=layers,
                flash_attention_bwd=layers, rms_norm_fwd=2 * layers + 1,
                rms_norm_bwd=2 * layers + 1)
    expert = 3 * cfg.hidden_size * cfg.intermediate_size * layers * e

    def flops_per_token(n_params):
        activated = n_params - int(expert * (e - 2) / e)
        return 6 * activated + 12 * layers * cfg.hidden_size * MOE_S
    return run_train(torch, np, card, "train-moe", cfg, MOE_B, MOE_S,
                     TRAIN_STEPS, want, flops_per_token)


# the context-parallel training path: bench_cp_long_context's
# configuration (bench.py:323-371) at seq 32768, as _llama_run runs it
CP_LAYERS = 4
CP_STEPS = 2            # timed steps after 1 + 1 warmup, as the bench times


def cp_config():
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=1024,
                       intermediate_size=2816, num_hidden_layers=CP_LAYERS,
                       num_attention_heads=CP_HQ, num_key_value_heads=CP_HKV,
                       max_position_embeddings=CP_SEQ, dtype="bfloat16",
                       sequence_parallel=True, sep_mode="auto")


def _cp_flops_per_token(n_params):
    return 6 * n_params + 12 * CP_LAYERS * cp_config().hidden_size * CP_SEQ


def _digest(model) -> str:
    """A hash of every parameter's bits (bf16 widens to fp32 exactly)."""
    return _digest_of(dict(model.named_parameters()))


def _digest_of(tensors) -> str:
    """A hash of named tensors' bits, in order."""
    import hashlib
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def timed_calls(torch, targets):
    """Inside the block, each ``(module, function name, kind)`` of
    ``targets`` adds its calls' wall time to the returned dict under
    ``kind``; each call is bracketed by device synchronisations, so the
    time is the call's own."""
    spent = {kind: 0.0 for _, _, kind in targets}
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def wrap(fn, kind):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t0
            return out
        return timed
    for mod, name, kind in targets:
        setattr(mod, name, wrap(getattr(mod, name), kind))
    try:
        yield spent
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


def timed_hops(torch):
    """The ring's hops: ``gloo`` for the collectives staged through the
    host (the all-gathers), ``ipc`` for the KV and dk/dv hops of
    ``ring_kv_rotate``."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    return timed_calls(torch, [(collective, "ppermute", "gloo"),
                               (collective, "all_gather", "gloo"),
                               (hops, "ring_kv_rotate", "ipc")])


def cp_run(torch, np, label, want, hops=False, profile=False):
    """``_llama_run``'s loop at the cp configuration in this process:
    the first step's loss and gradients (before any update), 1 + 1
    warmup steps, then ``CP_STEPS`` timed steps with the launch counts
    zeroed just before and read just after (``want``: per step); with
    ``profile``, one more step under the profiler."""
    from paddle_tpu_torch.ops import kernels
    torch.use_deterministic_algorithms(True, warn_only=True)
    model, opt, train_step = build_trainer(torch, cp_config())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 32000, size=(1, CP_SEQ)).astype("int32")).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    loss0, grads = loss_and_grads(torch, model, ids)
    grads = [g.bfloat16().cpu() for g in grads]     # bf16 grads: exact
    losses = [train_step(ids) for _ in range(2)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ctx = timed_hops(torch) if hops else contextlib.nullcontext(
        dict(gloo=0.0, ipc=0.0))
    with ctx as spent:
        t0 = time.perf_counter()
        for _ in range(CP_STEPS):
            losses.append(train_step(ids))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for name in kernels.KERNELS:
        assert counts[name] == want.get(name, 0) * CP_STEPS, \
            (label, name, counts)
    vals = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in vals), (label, vals)
    assert vals[-1] < vals[0], f"{label}: the loss did not fall: {vals}"
    tps = CP_SEQ * CP_STEPS / dt
    busy = None
    if profile:
        rows, dev_s, pwall = device_profile(torch, lambda: train_step(ids))
        busy = report_profile(label, rows, dev_s, pwall, dt / CP_STEPS)
    res = dict(loss0=loss0, losses=vals, busy_share=busy,
               loss_bits=[x.cpu().numpy().tobytes() for x in losses],
               counts=counts, ms_per_step=1e3 * dt / CP_STEPS,
               tokens_per_s=tps, n_params=n_params,
               mfu=tps * _cp_flops_per_token(n_params) / PEAK_FLOPS["bf16"],
               hop_share=spent["gloo"] / dt, ipc_share=spent["ipc"] / dt,
               names=[n for n, _ in model.named_parameters()],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               digest=_digest(model))
    del model, opt, train_step
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return res, grads


def _hop_check(torch):
    """#16's port in a rank of train-cp (b), before the path runs: the
    KV hop at the path's shape (bf16 K and V [1, 16384, 8, 64]) and the
    dk/dv hop (fp32, the same shape), each against its twin (a gloo
    ``ppermute`` through the host) bit for bit, then each timed beside
    the twin and (rank 0 alone on the card) beside the library's copy
    (``Tensor.copy_`` of K and of V from views of the source rank's mapped
    slot, one call a segment); the bound moves K and V in once and out
    once."""
    from paddle_tpu_torch.distributed import get_mesh
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    from paddle_tpu_torch.ops.kernels.kv_handoff import device_view
    mesh = get_mesh()
    group, me = mesh.group("sep"), mesh.axis_index("sep")
    perm = [(j, (j + 1) % CP_SP) for j in range(CP_SP)]
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(100 + me)
    out = {}
    for label, dtype in (("kv", torch.bfloat16), ("dkv", torch.float32)):
        k, v = (torch.randn(1, CP_SEQ // CP_SP, CP_HKV, CP_D, device="cuda",
                            generator=gen).to(dtype) for _ in range(2))
        got = hops.ring_kv_rotate(k, v, perm, group)
        want = hops.ring_kv_rotate_plain(k, v, perm, group)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            f"ring_kv_rotate {label}: the kernel's hop differs from the twin's"
        assert not torch.equal(got[0], k), \
            f"ring_kv_rotate {label}: nothing moved"
        b_ms, b_by = bound(4 * k.numel() * k.element_size(), 0, "bf16")
        call_ms = timer.ms(lambda: hops.ring_kv_rotate(k, v, perm, group))
        plain_ms = timer.ms(lambda: hops.ring_kv_rotate_plain(
            k, v, perm, group), iters=5)
        # the kernel's pull alone and the library's copy read the slot the
        # last hop staged; no rank restages it before the next hop's
        # barrier. Rank 0 times both alone on the card while the other
        # ranks wait at a barrier
        ms = lib_ms = None
        if me == 0:
            ms = timer.ms(lambda: hops.ring_kv_pull(k, v, perm, group))
            assert all(torch.equal(a, b) for a, b in zip(
                hops.ring_kv_pull(k, v, perm, group), got)), \
                f"ring_kv_rotate {label}: the pull alone differs"

            ring = hops._rings[group]
            theirs = ring.addr((me - 1) % CP_SP, ring.slot ^ 1)
            nbytes = k.numel() * k.element_size()
            pk, pv = (device_view(theirs + off, nbytes, k.device).view(
                dtype).view(k.shape) for off in (0, -(-nbytes // 256) * 256))
            ko, vo = torch.empty_like(k), torch.empty_like(v)
            lib_ms = timer.ms(lambda: (ko.copy_(pk), vo.copy_(pv)))
            assert torch.equal(ko, got[0]) and torch.equal(vo, got[1]), \
                f"ring_kv_rotate {label}: the library's copy differs"
        torch.distributed.barrier(group=group)
        out[label] = dict(
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by,
            shape=f"{str(dtype)[6:]} K and V [1, {CP_SEQ // CP_SP}, "
                  f"{CP_HKV}, {CP_D}]")
    del timer
    return out


def _cp_rank(rank, work_dir, want):
    """One rank of ``train-cp`` (b): a gloo group with its peer on the
    same card, a ``["sep"]`` mesh of two ranks, the KV hop's check, the
    step of ``cp_run``; writes its results, and rank 0 its first step's
    gradients."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch.distributed as dist
    env = dist.init_parallel_env(backend="gloo")
    dist.set_mesh(dist.ProcessMesh(list(range(CP_SP)), ["sep"]))
    hop = _hop_check(torch)
    res, grads = cp_run(torch, np, f"train-cp rank {rank}", want, hops=True)
    res.update(rank=rank, device=str(env.device), hop=hop,
               kind=torch.cuda.get_device_name(env.device))
    if rank == 0:
        torch.save(grads, os.path.join(work_dir, "grads0.pt"))
    torch.save(res, os.path.join(work_dir, f"rank{rank}.pt"))


def _cp_rank_control(rank, work_dir):
    """train-cp's planted ring fault, the control of its gradient check:
    (b)'s ranks and model, where rank 0 drops the dk/dv of its t=1
    backward step (the K/V rotated in from rank 1) in every layer; rank 0
    writes the first step's gradients."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    dist.init_parallel_env(backend="gloo")
    dist.set_mesh(dist.ProcessMesh(list(range(CP_SP)), ["sep"]))
    kept = fa.flash_attention_seg_bwd

    def dropped(q, k, v, o, lse, d_out, seg):
        dq, dk, dv = kept(q, k, v, o, lse, d_out, seg)
        if rank == 0 and seg[0] != seg[3]:
            dk, dv = torch.zeros_like(dk), torch.zeros_like(dv)
        return dq, dk, dv
    fa.flash_attention_seg_bwd = dropped
    torch.use_deterministic_algorithms(True, warn_only=True)
    model, _, _ = build_trainer(torch, cp_config())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 32000, size=(1, CP_SEQ)).astype("int32")).cuda()
    _, grads = loss_and_grads(torch, model, ids)
    if rank == 0:
        torch.save([g.bfloat16().cpu() for g in grads],
                   os.path.join(work_dir, "grads0.pt"))


def _leaf_rels(a, b):
    """Each parameter's gradient rel L2 of ``a`` against ``b``."""
    return [math.sqrt(float((x.float() - y.float()).square().sum())
                      / float(y.float().square().sum()))
            for x, y in zip(a, b)]


#: train-cp's limit on the worst parameter's gradient rel L2 of (b)
#: against (a), set between the sound run's reading and the planted
#: fault's (PERF.md, train-cp)
CP_LEAF_LIMIT = 5e-2


def phase_train_cp(torch, np, card):
    """The slice-6 path, ``bench_cp_long_context`` (``bench.py:323-371``:
    vocab 32000, hidden 1024, ffn 2816, 4 layers, 16:8 heads of 64, bf16,
    ``sequence_parallel=True``, ``sep_mode="auto"``, seq 32768, batch 1,
    seeded random weights), trained as ``_llama_run`` trains it. (a) One
    process without a mesh: #1 and #2 over the whole causal sequence. (b)
    ``distributed.spawn`` of two ranks sharing this one card over a gloo
    group (NCCL refuses two ranks on one GPU), a ``["sep"]`` mesh: the
    zig-zag ring, #3 at each layer's t=0, #1 on half slices at t=1, #4 at
    every backward step, the KV and dk/dv hops through #16's port. Checks:
    falling finite losses; both ranks the same loss and parameter bits;
    per step and rank #3 == 4, #4 == 8, #1 == 4, #16 == 32, #2 == 0, fused
    block == 0; step 1's loss of (b) within 2e-2 of (a)'s, its gradients
    within 2e-2 rel L2 of (a)'s over the model and each parameter's within
    ``CP_LEAF_LIMIT``, which
    the planted fault of ``_cp_rank_control`` must exceed; a second (b)
    from the seed bitwise equal. Returns the launch counts and #16's row
    of the ``kernels`` line."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    paddle.flags.set_flags({"pallas_fused_block": "auto"})
    layers = CP_LAYERS
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"train-cp: bench_cp_long_context (bench.py:323: vocab 32000, "
        f"hidden 1024, ffn 2816, 16:8 heads of 64), {layers} layers, bf16, "
        f"seq {CP_SEQ}, batch 1, AdamW(lr 1e-4, wd 0.1), seeded random "
        f"weights; compute mode {mode}")
    norms = dict(rms_norm_fwd=2 * layers + 1, rms_norm_bwd=2 * layers + 1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    one, grads_a = cp_run(torch, np, "train-cp (a)",
                          dict(flash_attention_fwd=layers,
                               flash_attention_bwd=layers, **norms),
                          profile=True)
    log(f"train-cp (a) one process, no mesh: " + json.dumps(
        {k: one[k] for k in ("ms_per_step", "tokens_per_s", "mfu",
                             "peak_gib", "losses", "n_params")}))
    # hops a layer: sp-1 KV hops forward, sp-1 KV hops and sp dk/dv hops
    # backward; two launches a hop (stage and pull)
    want = dict(flash_attention_seg_fwd=layers,
                flash_attention_seg_bwd=layers * CP_SP,
                flash_attention_fwd=layers * (CP_SP - 1),
                ring_kv_rotate=2 * layers * (3 * CP_SP - 2), **norms)
    gc.collect()
    torch.cuda.empty_cache()
    runs = []
    for attempt in range(2):
        with tempfile.TemporaryDirectory() as work:
            t0 = time.perf_counter()
            dist.spawn(_cp_rank, (work, want), nprocs=CP_SP, timeout=900)
            ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                                weights_only=False) for r in range(CP_SP)]
            if attempt == 0:
                grads_b = torch.load(os.path.join(work, "grads0.pt"))
            log(f"train-cp (b) run {attempt + 1}: {CP_SP} ranks in "
                f"{time.perf_counter() - t0:.1f} s on "
                f"{[r['device'] + ' ' + r['kind'] for r in ranks]}")
        for r in ranks:
            log(f"train-cp (b) rank {r['rank']}: " + json.dumps(
                {k: r[k] for k in ("ms_per_step", "tokens_per_s", "mfu",
                                   "hop_share", "ipc_share", "peak_gib",
                                   "losses")}))
            for label, h in r["hop"].items():
                log(f"train-cp (b) rank {r['rank']} ring_kv_rotate "
                    f"{label}: {h['shape']}: equal to the twin bit for bit, "
                    f"the whole call {h['call_ms']:.4f} ms, plain "
                    f"{h['plain_ms']:.4f} ms; rank 0 alone: the pull "
                    f"{h['ms']} ms, the library's copy_ of K and V from the "
                    f"mapped slot {h['library_ms']} ms; bound "
                    f"{h['bound_ms']:.4f} ms ({h['bound_by']}) on {card}")
        r0 = ranks[0]
        for r in ranks[1:]:
            assert r["loss_bits"] == r0["loss_bits"], \
                "train-cp (b): the ranks' losses differ"
            assert r["digest"] == r0["digest"], \
                "train-cp (b): the ranks' parameters differ"
        runs.append(r0)
    assert runs[1]["loss_bits"] == runs[0]["loss_bits"] and \
        runs[1]["digest"] == runs[0]["digest"], \
        "train-cp (b): a second run from the seed differs"
    b = runs[0]
    with tempfile.TemporaryDirectory() as work:
        dist.spawn(_cp_rank_control, (work,), nprocs=CP_SP, timeout=600)
        grads_c = torch.load(os.path.join(work, "grads0.pt"))
    leaf_b, leaf_c = _leaf_rels(grads_b, grads_a), _leaf_rels(grads_c, grads_a)
    worst_b, worst_c = max(leaf_b), max(leaf_c)
    names = one["names"]
    rel = math.sqrt(sum(float((x.float() - y.float()).square().sum())
                        for x, y in zip(grads_b, grads_a))
                    / sum(float(y.float().square().sum()) for y in grads_a))
    msg = (f"train-cp: step 1 of (b) against (a): loss {b['loss0']:.6f} vs "
           f"{one['loss0']:.6f}; gradients rel L2 {rel:.4g} over the model, "
           f"worst parameter {names[leaf_b.index(worst_b)]} {worst_b:.4g}; "
           f"the planted fault (rank 0 drops its t=1 dk/dv) worst "
           f"{names[leaf_c.index(worst_c)]} {worst_c:.4g}; limit "
           f"{CP_LEAF_LIMIT:g} (the model's 2e-2)")
    log(msg)
    assert abs(b["loss0"] - one["loss0"]) <= 2e-2 * abs(one["loss0"]), msg
    assert rel <= 2e-2 and worst_b <= CP_LEAF_LIMIT < worst_c, msg
    perf = dict(one_process=dict(ms_per_step=one["ms_per_step"],
                                 tokens_per_s=one["tokens_per_s"],
                                 mfu=one["mfu"],
                                 busy_share=one["busy_share"]),
                two_ranks_one_card=dict(ms_per_step=b["ms_per_step"],
                                        tokens_per_s=b["tokens_per_s"],
                                        mfu=b["mfu"],
                                        hop_share=b["hop_share"],
                                        ipc_share=b["ipc_share"]),
                grad_rel_l2_vs_one_process=rel, worst_leaf_rel_l2=worst_b,
                planted_fault_worst_leaf_rel_l2=worst_c, card=card)
    log("train-cp: " + json.dumps(perf) + " (MFU by the bench's 6N + "
        "12*L*h*s against one card's 989 TFLOP/s; the two ranks share one "
        "card, so (b) is not context-parallel scaling)")
    hop = b["hop"]["kv"]
    row = dict(name="ring_kv_rotate", route="cuda",
               source="paddle_tpu_torch/csrc/async_collectives.cu",
               replaces="paddle_tpu/ops/pallas/async_collectives.py:294",
               path="train-cp", max_abs_err=0.0, tolerance="bitwise",
               ms=hop["ms"], call_ms=hop["call_ms"], plain_ms=hop["plain_ms"],
               bound_ms=hop["bound_ms"], bound_by=hop["bound_by"],
               library_ms=hop["library_ms"], shape=hop["shape"] + ", rank 0 "
               "of 2 on one card (ms: the pull alone, rank 0 alone on the "
               "card; call_ms: stage, sync, barrier and pull); plain: a gloo "
               "ppermute through the host; library: Tensor.copy_ of K and of "
               "V from the source's mapped slot")
    return {"train-cp": b["counts"],
            "train-cp-one-process": one["counts"]}, row


# the expert-parallel MoE training path: bench_moe's configuration
# (bench.py:122-129) trained on an ["ep"] mesh of two ranks sharing the card
EP = 2
EP_STEPS = 3            # timed steps after 1 + 1 warmup
EP_FLAGS = dict(moe_a2a_dispatch="auto", pallas_async_a2a="auto",
                moe_a2a_fused_kernel="auto", moe_a2a_overlap=False,
                moe_a2a_chunks=2)
# the three dispatch modes of the reference: (b1) the default flags, the
# fused kernel at one chunk; (b2) overlap, the fused kernel owning both
# chunks; (b3) the pipelined composed path
EP_MODES = {"b1": {}, "b2": dict(moe_a2a_overlap=True),
            "b3": dict(moe_a2a_fused_kernel="off")}
EP_PATHS = {"b1": "train-moe-ep", "b2": "train-moe-ep-overlap",
            "b3": "train-moe-ep-composed"}
#: train-moe-ep's limit on the worst parameter's gradient rel L2 of a mode
#: against one process, set between the sound runs' readings (worst 0.00285,
#: (b2)'s per-chunk bf16 dW sums) and the planted fault's (1.06) (PERF.md,
#: train-moe-ep)
EP_LEAF_LIMIT = 1e-2
# the layer-level run (c): bench_moe_overlap_efficiency (bench.py:176-260)
EPC_RANKS, EPC_HIDDEN, EPC_FFN, EPC_E, EPC_TOKENS, EPC_STEPS = (
    4, 1024, 2816, 16, 16, 6)


def ep_want(mode, layers):
    """Launches per step and rank of a mode, as the code makes them."""
    chunks = 2 if mode == "b2" else 1
    fused = mode != "b3"
    # per layer and chunk: gmm2 and the down gmm forward (in the fused
    # modes, the backward's recompute of the composed reference), three
    # gmm against w^T and three tgmm. #15: the fused modes exchange the
    # ids, the combine and its mirror, the recomputed dispatch and its
    # transpose; the composed mode the payload, the ids, the combine, and
    # the mirrors of the combine and of the payload. #17 once a layer,
    # both chunks in one launch.
    return dict(gmm2=layers * chunks, gmm_fwd=layers * chunks,
                gmm_bwd=3 * layers * chunks, tgmm=3 * layers * chunks,
                tiled_a2a=5 * layers * chunks,
                fused_a2a_expert_mlp=layers if fused else 0,
                flash_attention_fwd=layers, flash_attention_bwd=layers,
                rms_norm_fwd=2 * layers + 1, rms_norm_bwd=2 * layers + 1)


def ep_inputs(torch, mesh, tokens, experts, hidden, ffn, cf, chunks, dtype,
              seed=0, empty_expert=None):
    """#17's inputs as the path makes them on this rank: global tokens and
    their gshard routing (``empty_expert``: no token routes there), this
    rank's rows packed for each chunk (``moe_a2a._pack_chunks``), this
    rank's block of random experts at the init scale. Returns ``(x_send,
    counts, inv, wg, wu, wd, plan)``."""
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_a2a
    r = mesh.axis_index("ep")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tokens, hidden, generator=g, device="cuda")
    gate = moe.GShardGate(hidden, experts, device="cuda", generator=g)
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
    wg, wu = (torch.randn(experts, hidden, ffn, generator=g, device="cuda")
              [r * e_l:(r + 1) * e_l].mul(0.02).to(dtype) for _ in range(2))
    wd = torch.randn(experts, ffn, hidden, generator=g, device="cuda")[
        r * e_l:(r + 1) * e_l].mul(0.02).to(dtype)
    return x_send, counts, inv, wg, wu, wd, plan


def _fused_library(torch, x_send, counts, inv, wg, wu, wd, plan):
    """The PyTorch calls that compute #17's chunk on this rank's inputs
    once the exchange has landed: the inv gather, then ``grouped_mm`` for
    gate, up and down over the padded buffer (no ragged skip). The
    exchange runs once, outside the timed function. Returns the function
    (None without a grouped GEMM in this torch) and its name."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    fn, name = grouped_mm_library(torch)
    if fn is None:
        return None, None
    recv = hops.tiled_a2a_plain(x_send, plan.group)
    idx = inv.long()
    live = (idx < recv.shape[0]).to(recv.dtype)[:, None]
    idx = torch.where(idx < recv.shape[0], idx, torch.zeros_like(idx))
    offs = (torch.arange(1, plan.e_local + 1, device="cuda")
            * plan.c_pad).to(torch.int32)

    def lib():
        xb = F.embedding(idx, recv) * live
        act = F.silu(fn(xb, wg, offs=offs)) * fn(xb, wu, offs=offs)
        return fn(act, wd, offs=offs)
    return lib, f"embedding gather + {name} x3"


def _fused_tpu_numerics(torch, x_send, counts, inv, wg, wu, wd, plan):
    """#17 with the TPU kernel's arithmetic (``_fused_kernel``,
    ``paddle_tpu/ops/pallas/async_collectives.py:464-476``) on this rank's
    inputs: the twin's exchange and ``inv`` gather, then gate and up kept
    in fp32, ``silu(g) * u`` rounded once to the compute dtype, the down
    projection accumulated in fp32 and rounded on the store. #17 rounds
    gate and up to the compute dtype first, as the composed path's gmm2
    does (ROADMAP.md C); this measures that departure."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    wb, rows = plan.ep * plan.bucket, plan.e_local * plan.c_pad
    ys = []
    for c in range(plan.chunks):
        recv = hops.tiled_a2a_plain(x_send[c * wb:(c + 1) * wb], plan.group)
        ic = inv[c * rows:(c + 1) * rows].long()
        live = ic < wb
        xb = (F.embedding(torch.where(live, ic, torch.zeros_like(ic)), recv)
              * live.to(recv.dtype)[:, None]).float().reshape(
                  plan.e_local, plan.c_pad, -1)
        act = (F.silu(torch.bmm(xb, wg.float()))
               * torch.bmm(xb, wu.float())).to(x_send.dtype)
        ys.append(torch.bmm(act.float(), wd.float()).to(x_send.dtype)
                  .reshape(rows, -1))
        del xb, act
    return ys[0] if plan.chunks == 1 else torch.cat(ys)


def _pull_alone(torch, timer, group, call, pull):
    """An exchange kernel's launch alone, as #18's row takes it: every rank
    makes one whole ``call`` (which stages the slot), then rank 0 times
    ``pull`` (the bare launch on that staged slot) while its peers wait at
    a barrier; the result equals the call's. Returns rank 0's ms (None on
    the other ranks)."""
    want = call()
    ms = None
    if torch.distributed.get_rank(group) == 0:
        ms = timer.ms(pull)
        assert torch.equal(pull(), want), "the launch alone differs from " \
            "the whole call"
    torch.distributed.barrier(group=group)
    return ms


def _ep_kernel_checks(torch, mesh):
    """#15 and #17 between the ranks on the card, before the path runs, at
    the path's shapes: #15 on (b1)'s payload x_send [32768, 1024] bf16, its
    int32 ids and (b2)'s chunk-pair payload [16384, 1024], each bit for bit
    against the twin (the gloo exchange through the host); #17 on the
    path's packed inputs at (b1) (bf16, one chunk) and (b2) (two chunks),
    in fp32, and at cf 1.0 (drops) with an expert no token routes to, each
    against its twin at the op-harness tier scaled by max|twin| with a
    second launch bitwise, and against the TPU kernel's arithmetic
    (``_fused_tpu_numerics``) at the same tier scaled by its max. Each
    timed beside its twin, #17 also beside the library calls; bounds from
    this run's inputs."""
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    group = mesh.group("ep")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(200 + mesh.axis_index(
        "ep"))
    n = MOE_B * MOE_S
    cases = []
    for shape, dtype in (((EP * n, MOE_HIDDEN), torch.bfloat16),
                         ((EP * n,), torch.int32),
                         ((EP * n // 2, MOE_HIDDEN), torch.bfloat16)):
        x = (torch.randn(shape, device="cuda", generator=gen) * 100).to(dtype)
        got = hops.tiled_a2a(x, group)
        want = hops.tiled_a2a_plain(x, group)
        assert torch.equal(got, want), \
            f"tiled_a2a {shape} {dtype}: the kernel differs from the twin"
        assert not torch.equal(got, x), f"tiled_a2a {shape}: nothing moved"
        cases.append(f"{str(dtype)[6:]} {list(shape)}")
    x = torch.randn(EP * n, MOE_HIDDEN, device="cuda",
                    generator=gen).bfloat16()
    b_ms, b_by = bound(2 * x.numel() * 2, 0, "bf16")
    a2a = dict(call_ms=timer.ms(lambda: hops.tiled_a2a(x, group)),
               plain_ms=timer.ms(lambda: hops.tiled_a2a_plain(x, group),
                                 iters=3, warmup=1),
               ms=_pull_alone(torch, timer, group, lambda: hops.tiled_a2a(
                   x, group), lambda: hops.tiled_a2a_pull(x, group)),
               bound_ms=b_ms, bound_by=b_by, checked=cases,
               shape=f"bf16 x_send [{EP * n}, {MOE_HIDDEN}] on rank 0 of "
                     f"{EP} on one card (ms: the pull alone, rank 0 alone "
                     f"on the card; call_ms: stage, sync, barrier and "
                     f"pull); plain: a gloo all_to_all through the host")
    del x
    fused, worst = [], 0.0
    for label, kw in (("b1 bf16", dict(chunks=1, dtype=torch.bfloat16)),
                      ("b2 bf16", dict(chunks=2, dtype=torch.bfloat16)),
                      ("fp32", dict(chunks=1, dtype=torch.float32)),
                      ("cf 1.0 bf16, expert 5 empty",
                       dict(chunks=1, dtype=torch.bfloat16, cf=1.0,
                            empty_expert=5))):
        kw = dict(dict(cf=2.0), **kw)
        args = ep_inputs(torch, mesh, n, MOE_E, MOE_HIDDEN, MOE_FFN, **kw)
        x_send, counts, _, wg, _, _, plan = args
        call = dict(group=group, chunks=plan.chunks, bucket=plan.bucket,
                    c_pad=plan.c_pad)
        got = hops.fused_a2a_expert_mlp(*args[:6], **call)
        again = hops.fused_a2a_expert_mlp(*args[:6], **call)
        want = hops.fused_a2a_expert_mlp_plain(*args[:6], **call)
        tpu = _fused_tpu_numerics(torch, *args)
        torch.cuda.synchronize()
        tol = (1e-5, 1e-5) if kw["dtype"] == torch.float32 else (2e-2, 2e-2)
        err = max_err(got, want)
        ok = scaled_close(got, want, *tol)
        tpu_ok = scaled_close(got, tpu, *tol)
        scale = float(want.float().abs().max())
        t_scale = float(tpu.float().abs().max())
        fused.append(dict(case=label, max_abs_err=err, max_twin=scale,
                          tpu_gap=max_err(got, tpu) / t_scale,
                          twin_tpu_gap=max_err(want, tpu) / t_scale,
                          bitwise=torch.equal(got, again),
                          live=int(counts.sum()),
                          empty=int((counts == 0).sum()),
                          bucket=plan.bucket, c_pad=plan.c_pad))
        assert ok, f"fused_a2a_expert_mlp {label}: max_abs_err {err} " \
                   f"(max|twin| {scale}) beyond rtol {tol[0]}, atol " \
                   f"{tol[1]} x max|twin|"
        assert fused[-1]["bitwise"], \
            f"fused_a2a_expert_mlp {label}: a second launch differs"
        assert tpu_ok, f"fused_a2a_expert_mlp {label}: " \
                       f"{fused[-1]['tpu_gap']} x max|y| from the TPU " \
                       f"kernel's arithmetic, beyond rtol {tol[0]}, atol " \
                       f"{tol[1]} x max|y|"
        if kw["dtype"] == torch.bfloat16:
            worst = max(worst, err)
        if label == "b1 bf16":
            live = int(counts.sum())
            nbytes = (x_send.numel() + 3 * wg.numel() + got.numel()) * 2
            f_ms, f_by = bound(nbytes, 6 * live * MOE_HIDDEN * MOE_FFN,
                               "bf16")
            lib, lib_name = _fused_library(torch, *args)
            lib_ms = None
            if lib is not None:
                l_err = max_err(lib(), got)
                lib_ms = timer.ms(lib)
                log(f"library {lib_name}: max_abs_err against the kernel "
                    f"{l_err:.3g}")
            timed = dict(
                call_ms=timer.ms(lambda: hops.fused_a2a_expert_mlp(
                    *args[:6], **call)),
                ms=_pull_alone(
                    torch, timer, group,
                    lambda: hops.fused_a2a_expert_mlp(*args[:6], **call),
                    lambda: hops.fused_a2a_expert_mlp_pull(*args[:6],
                                                           **call)),
                plain_ms=timer.ms(lambda: hops.fused_a2a_expert_mlp_plain(
                    *args[:6], **call), iters=3, warmup=1),
                bound_ms=f_ms, bound_by=f_by, library_ms=lib_ms,
                library=lib_name, live_rows=live,
                shape=f"bf16 x_send {list(x_send.shape)}, {plan.e_local} "
                      f"local experts of ffn {MOE_FFN}, {live} live rows, "
                      f"bucket {plan.bucket}, c_pad {plan.c_pad}, rank 0 "
                      f"of {EP} on one card (ms: the launch alone, rank 0 "
                      f"alone on the card; call_ms: stage, sync, barrier "
                      f"and launch)")
        del args, x_send, got, again, want, tpu
        torch.cuda.empty_cache()
    timed.update(cases=fused, max_abs_err=worst)
    del timer
    return dict(a2a=a2a, fused=timed)


def ep_run(torch, np, mesh, mode, want):
    """One mode of train-moe-ep on this rank: the model from the seed with
    its experts sharded over ep (``llama_shard_fn``), step 1's loss and
    gradients (the experts' gathered back to ``[E, ...]``), 1 + 1 warmup
    steps, then ``EP_STEPS`` timed steps with the launch counts zeroed just
    before and read just after (``want``: per step), the host-staged
    all-gathers and the #15/#17 calls timed apart."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.models import llama_shard_fn
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import async_collectives as hops
    from paddle_tpu_torch.weights import gather_experts
    torch.use_deterministic_algorithms(True, warn_only=True)
    model, opt, train_step = build_trainer(
        torch, moe_config(),
        prepare=lambda m: dist.shard_layer(m, mesh, llama_shard_fn(mesh)))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 32000, size=(MOE_B, MOE_S)).astype("int32")).cuda()
    names = [n for n, _ in model.named_parameters()]
    loss0, grads = loss_and_grads(torch, model, ids)
    grads = gather_experts(model, dict(zip(names, grads)))
    grads = [grads[n].bfloat16().cpu() for n in names]
    torch.cuda.reset_peak_memory_stats()
    losses = [train_step(ids) for _ in range(2)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with timed_calls(torch, [(collective, "all_gather", "gloo"),
                             (hops, "tiled_a2a", "a2a"),
                             (hops, "fused_a2a_expert_mlp", "a2a")]) as spent:
        t0 = time.perf_counter()
        for _ in range(EP_STEPS):
            losses.append(train_step(ids))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for name in kernels.KERNELS:
        assert counts[name] == want.get(name, 0) * EP_STEPS, \
            (mode, name, counts)
    vals = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in vals), (mode, vals)
    assert vals[-1] < vals[0], f"train-moe-ep {mode}: the loss did not " \
                               f"fall: {vals}"
    full = gather_experts(model)
    shards = {n for n, p in model.named_parameters()
              if full[n].shape != p.shape}
    res = dict(loss0=loss0, losses=vals, counts=counts,
               loss_bits=[x.cpu().numpy().tobytes() for x in losses],
               ms_per_step=1e3 * dt / EP_STEPS,
               tokens_per_s=MOE_B * MOE_S * EP_STEPS / dt,
               gather_share=spent["gloo"] / dt, a2a_share=spent["a2a"] / dt,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               replicated_digest=_digest_of(
                   {n: t for n, t in full.items() if n not in shards}),
               digest=_digest_of(full), names=names)
    del model, opt, train_step, full
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return res, grads


def _ep_setup():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    env = dist.init_parallel_env(backend="gloo")
    mesh = dist.ProcessMesh(list(range(dist.get_world_size())), ["ep"])
    dist.set_mesh(mesh)
    paddle.flags.set_flags(dict(EP_FLAGS, pallas_fused_block="auto",
                                moe_fused_wi=True))
    return torch, paddle, env, mesh


def _ep_rank(rank, work_dir):
    """One rank of train-moe-ep's first spawn: a gloo group with its peer
    on the same card, an ``["ep"]`` mesh of two ranks, the #15/#17 kernel
    checks, then (b1), (b2) and (b3) from the seed; writes its results,
    and rank 0 each mode's first-step gradients."""
    import numpy as np
    torch, paddle, env, mesh = _ep_setup()
    out = dict(rank=rank, device=str(env.device),
               kind=torch.cuda.get_device_name(env.device),
               kernels=_ep_kernel_checks(torch, mesh))
    layers = moe_config().num_hidden_layers
    for mode, values in EP_MODES.items():
        paddle.flags.set_flags(dict(EP_FLAGS, **values))
        out[mode], grads = ep_run(torch, np, mesh, mode,
                                  ep_want(mode, layers))
        if rank == 0:
            torch.save(grads, os.path.join(work_dir, f"grads_{mode}.pt"))
    torch.save(out, os.path.join(work_dir, f"rank{rank}.pt"))


def _ep_rank_control(rank, work_dir):
    """train-moe-ep's planted fault, the control of its gradient check:
    (b1)'s ranks and model, where rank 0 drops its peer's block of every
    layer's combine (the outputs its peer's experts computed for its
    tokens); rank 0 writes the first step's gradients."""
    import numpy as np
    torch, paddle, env, mesh = _ep_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_a2a
    from paddle_tpu_torch.models import llama_shard_fn
    from paddle_tpu_torch.weights import gather_experts
    kept, exchange = moe_a2a.combine_local, coll.ragged_all_to_all

    def dropped(y_buf, state, w, keep, *, group, ep):
        def faulty(x, dest=None, **kw):
            out = exchange(x, dest, **kw)
            if rank == 0:
                rows = out.shape[0] // ep
                mask = torch.ones(out.shape[0], 1, dtype=out.dtype,
                                  device=out.device)
                mask[rows:2 * rows] = 0
                out = out * mask
            return out
        coll.ragged_all_to_all = faulty
        try:
            return kept(y_buf, state, w, keep, group=group, ep=ep)
        finally:
            coll.ragged_all_to_all = exchange
    moe_a2a.combine_local = dropped
    torch.use_deterministic_algorithms(True, warn_only=True)
    model, _, _ = build_trainer(
        torch, moe_config(),
        prepare=lambda m: dist.shard_layer(m, mesh, llama_shard_fn(mesh)))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 32000, size=(MOE_B, MOE_S)).astype("int32")).cuda()
    names = [n for n, _ in model.named_parameters()]
    _, grads = loss_and_grads(torch, model, ids)
    grads = gather_experts(model, dict(zip(names, grads)))
    if rank == 0:
        torch.save([grads[n].bfloat16().cpu() for n in names],
                   os.path.join(work_dir, "grads_fault.pt"))


def _ep_layer_rank(rank, work_dir):
    """One rank of the layer-level run (c): ``bench_moe_overlap_efficiency``
    (bench.py:176-260) as four ranks sharing the card, an ``["ep"]`` mesh
    of four: an fp32 ``MoELayer`` (hidden 1024, 16 SwiGLU experts of ffn
    2816, gshard cf 2.0) over 16 tokens a rank, its first output against
    the same layer on the one-device path, then fwd + bwd + AdamW under
    ``to_static``, one step then 6 timed, ``moe_a2a_overlap`` off and on.
    Writes tokens/s and the launches of each."""
    import numpy as np
    torch, paddle, env, mesh = _ep_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import kernels
    cfg = L.LlamaConfig(hidden_size=EPC_HIDDEN, intermediate_size=EPC_FFN)
    n = EPC_TOKENS * EPC_RANKS
    x = torch.from_numpy(np.random.RandomState(0).randn(
        n, EPC_HIDDEN).astype("float32")).cuda()

    def layer_of(sharded):
        gen = torch.Generator(device="cuda").manual_seed(0)
        init = L._Init(cfg, torch.device("cuda"), gen)
        layer = MoELayer(EPC_HIDDEN, [L.LlamaMLP(cfg, init)
                                      for _ in range(EPC_E)], gate="gshard",
                         capacity_factor=2.0, generator=gen,
                         mesh=mesh if sharded else None)
        return layer.shard_experts(mesh) if sharded else layer

    out = {}
    for overlap in (False, True):
        paddle.flags.set_flags(dict(EP_FLAGS, moe_a2a_overlap=overlap))
        layer = layer_of(True)
        with torch.no_grad():
            y = layer(x)
            dist.set_mesh(None)             # the one-device path
            y_one = layer_of(False)(x)
            dist.set_mesh(mesh)
        ok = scaled_close(y, y_one, 1e-5, 1e-5)
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=layer.parameters())

        @paddle.jit.to_static
        def step(inp):
            yy = layer(inp)
            loss = (yy * yy).mean() + 0.01 * layer.gate.get_loss()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        step(x)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [step(x) for _ in range(EPC_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["on" if overlap else "off"] = dict(
            tokens_per_s=n * EPC_STEPS / dt, ms_per_step=1e3 * dt / EPC_STEPS,
            counts=kernels.launch_counts(), y_close=ok,
            y_err=max_err(y, y_one), losses=[float(v) for v in losses])
        del layer, opt, step
    torch.save(out, os.path.join(work_dir, f"layer{rank}.pt"))


def phase_train_moe_ep(torch, np, card):
    """The slice-7 path, train-moe-ep: ``bench_moe``'s configuration
    (``bench.py:122-129``) trained with AdamW on an ``["ep"]`` mesh of two
    ``distributed.spawn`` ranks sharing this one card over gloo (NCCL
    refuses two ranks on one GPU), the fixed batch 8 x 2048 of train-moe,
    each rank holding the replicated model, its 8 of the 16 experts and
    8,192 of the 16,384 tokens' dispatch. Checks: #15/#17 against their
    twins at the path's shapes (``_ep_kernel_checks``); in each of (b1),
    (b2), (b3): launches per step and rank as ``ep_want`` derives them,
    falling finite losses, both ranks the same loss bits and the same bits
    in every replicated parameter (and the gathered experts), step 1's
    loss within the bf16 tier of one process at the same seed and batch,
    its gradients within 2e-2 rel L2 over the model and each parameter's
    within ``EP_LEAF_LIMIT``, which a planted combine fault must exceed.
    Then the layer-level run (c) at ep 4. Returns the launch counts by path
    and the #15 and #17 rows of the ``kernels`` line."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    paddle.flags.set_flags(dict(EP_FLAGS, pallas_fused_block="auto",
                                moe_fused_wi=True))
    cfg = moe_config()
    layers, e = cfg.num_hidden_layers, cfg.moe_num_experts
    log(f"train-moe-ep: bench_moe (bench.py:122: vocab 32000, hidden 1024, "
        f"16 experts of ffn 704, top-2 gshard, cf 2.0, 16:16 heads), "
        f"{layers} layers, bf16, batch {MOE_B} x seq {MOE_S}, AdamW(lr 1e-4, "
        f"wd 0.1), seeded random weights, {EP} ranks sharing one card on an "
        f"['ep'] mesh (gloo)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True, warn_only=True)
    model, _, _ = build_trainer(torch, cfg)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(MOE_B, MOE_S)).astype("int32")).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    names = [n for n, _ in model.named_parameters()]
    loss_one, grads_one = loss_and_grads(torch, model, ids)
    grads_one = [g.bfloat16().cpu() for g in grads_one]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    expert = 3 * cfg.hidden_size * cfg.intermediate_size * layers * e
    flops_per_token = (6 * (n_params - int(expert * (e - 2) / e))
                       + 12 * layers * cfg.hidden_size * MOE_S)

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        dist.spawn(_ep_rank, (work,), nprocs=EP, timeout=900)
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(EP)]
        grads = {m: torch.load(os.path.join(work, f"grads_{m}.pt"))
                 for m in EP_MODES}
        log(f"train-moe-ep: {EP} ranks in {time.perf_counter() - t0:.1f} s "
            f"on {[r['device'] + ' ' + r['kind'] for r in ranks]}; kernels "
            f"(rank 0): {json.dumps(ranks[0]['kernels'])}")
    with tempfile.TemporaryDirectory() as work:
        dist.spawn(_ep_rank_control, (work,), nprocs=EP, timeout=600)
        grads_fault = torch.load(os.path.join(work, "grads_fault.pt"))
    counts, perf, checks = {}, dict(card=card, one_process_loss=loss_one), []
    leaf_c = _leaf_rels(grads_fault, grads_one)
    worst_c = max(leaf_c)
    for mode in EP_MODES:
        r0 = ranks[0][mode]
        for r in ranks[1:]:
            assert r[mode]["loss_bits"] == r0["loss_bits"], \
                f"train-moe-ep {mode}: the ranks' losses differ"
            assert r[mode]["replicated_digest"] == r0["replicated_digest"] \
                and r[mode]["digest"] == r0["digest"], \
                f"train-moe-ep {mode}: the ranks' parameters differ"
        leaf = _leaf_rels(grads[mode], grads_one)
        worst = max(leaf)
        rel = math.sqrt(sum(float((x.float() - y.float()).square().sum())
                            for x, y in zip(grads[mode], grads_one))
                        / sum(float(y.float().square().sum())
                              for y in grads_one))
        tps = r0["tokens_per_s"]
        perf[mode] = dict(
            ms_per_step=r0["ms_per_step"], tokens_per_s=tps,
            mfu=tps * flops_per_token / PEAK_FLOPS["bf16"],
            gather_share=r0["gather_share"], a2a_share=r0["a2a_share"],
            peak_gib=r0["peak_gib"], losses=r0["losses"],
            loss0=r0["loss0"], grad_rel_l2_vs_one_process=rel,
            worst_leaf=worst, worst_leaf_name=names[leaf.index(worst)],
            ms_per_step_rank1=ranks[1][mode]["ms_per_step"])
        msg = (f"train-moe-ep {mode}: step 1 against one process: loss "
               f"{r0['loss0']:.6f} vs {loss_one:.6f}; gradients rel L2 "
               f"{rel:.4g} over the model, worst parameter "
               f"{names[leaf.index(worst)]} {worst:.4g}; the planted fault "
               f"worst {names[leaf_c.index(worst_c)]} {worst_c:.4g}; limit "
               f"{EP_LEAF_LIMIT:g}")
        log(msg)
        log(f"train-moe-ep {mode}: " + json.dumps(perf[mode]))
        checks.append((abs(r0["loss0"] - loss_one) <= 2e-2 * abs(loss_one)
                       and rel <= 2e-2 and worst <= EP_LEAF_LIMIT < worst_c,
                       msg))
        counts[EP_PATHS[mode]] = r0["counts"]
    for ok, msg in checks:
        assert ok, msg
    perf["planted_fault_worst_leaf"] = worst_c
    log("train-moe-ep: " + json.dumps(perf) + " (MFU by bench_moe's "
        "activated-parameter formula against one card's 989 TFLOP/s; the "
        "two ranks share one card, so this is not expert-parallel scaling)")

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        dist.spawn(_ep_layer_rank, (work,), nprocs=EPC_RANKS, timeout=600)
        layer = [torch.load(os.path.join(work, f"layer{r}.pt"))
                 for r in range(EPC_RANKS)]
    for r, res in enumerate(layer):
        for key, run in res.items():
            assert run["y_close"], \
                f"train-moe-ep (c) rank {r} overlap {key}: the layer's " \
                f"output is {run['y_err']} from the one-device layer's"
    off, on = layer[0]["off"], layer[0]["on"]
    log(f"train-moe-ep (c): bench_moe_overlap_efficiency (hidden "
        f"{EPC_HIDDEN}, {EPC_E} experts of ffn {EPC_FFN}, {EPC_TOKENS} tokens "
        f"a rank, ep {EPC_RANKS} on one card, fp32): overlap off "
        f"{off['tokens_per_s']:.1f} tok/s ({off['ms_per_step']:.2f} ms), on "
        f"{on['tokens_per_s']:.1f} tok/s ({on['ms_per_step']:.2f} ms), ratio "
        f"{on['tokens_per_s'] / off['tokens_per_s']:.4f} (not asserted); "
        f"output against the one-device layer {off['y_err']:.3g}; in "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    counts["train-moe-ep-layer"] = off["counts"]
    counts["train-moe-ep-layer-overlap"] = on["counts"]

    k = ranks[0]["kernels"]
    for c in k["fused"]["cases"]:
        log(f"kernel fused_a2a_expert_mlp {c['case']}: max_abs_err "
            f"{c['max_abs_err']:.3g} (max|twin| {c['max_twin']:.3g}), "
            f"second launch bitwise, {c['live']} live rows, {c['empty']} "
            f"empty experts, bucket {c['bucket']}, c_pad {c['c_pad']}; "
            f"from the TPU kernel's arithmetic (gate and up in fp32): the "
            f"kernel {c['tpu_gap']:.4g}, the twin {c['twin_tpu_gap']:.4g} "
            f"x max|y|")
    rows = [dict(name="tiled_a2a", route="cuda",
                 source="paddle_tpu_torch/csrc/async_collectives.cu",
                 replaces="paddle_tpu/ops/pallas/async_collectives.py:187",
                 path="train-moe-ep", max_abs_err=0.0, tolerance="bitwise",
                 library_ms=None, **{x: k["a2a"][x] for x in (
                     "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                     "shape")}),
            dict(name="fused_a2a_expert_mlp", route="cuda",
                 source="paddle_tpu_torch/csrc/async_collectives.cu",
                 replaces="paddle_tpu/ops/pallas/async_collectives.py:480",
                 path="train-moe-ep",
                 tolerance="bf16 rtol=atol=2e-2 x max|twin|; fp32 rtol "
                           "1e-5, atol 1e-5 x max|twin|",
                 **{x: k["fused"][x] for x in (
                     "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms", "shape")})]
    for row in rows:
        log(f"kernel {row['name']}: {row['shape']}: max_abs_err "
            f"{row['max_abs_err']:.3g} (tol {row['tolerance']}), "
            f"{row['ms']:.4f} ms alone, {row['call_ms']:.4f} ms the whole "
            f"call, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']}, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) on {card}")
    return counts, rows


# the kernels redesigned around wgmma (#1's bf16 forward, #17's bf16
# gate/up and down launches), by a fragment of their mangled names
WGMMA_KERNELS = ("flash_fwd_wgmma", "fused_gate_up_wgmma", "fused_down_wgmma",
                 "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma", "gmm_wgmma")


def check_tensor_core_kernels():
    """Each redesigned kernel holds HGMMA instructions (``cuobjdump -sass``
    of the built library, where the toolkit has it) and spills nothing
    (``ptxas -v``)."""
    from paddle_tpu_torch.ops.kernels import _build
    hgmma = _build.sass_opcode_counts("HGMMA")
    spills = _build.ptxas_spills()
    for name in WGMMA_KERNELS:
        fns = [f for f in spills if name in f]
        assert fns, f"build: ptxas reports no kernel named *{name}*"
        for f in fns:
            assert spills[f] == (0, 0), f"build: {f} spills {spills[f]}"
        if hgmma is None:
            log(f"build: {name}: no cuobjdump in the toolkit, HGMMA not "
                f"counted")
            continue
        n = sum(c for f, c in hgmma.items() if name in f)
        log(f"build: {name}: {n} HGMMA instructions (cuobjdump -sass), "
            f"{len(fns)} instantiations, no spills (ptxas -v)")
        assert n > 0, f"build: {name} issues no HGMMA"


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
            if ("registers" in ln or "spill" in ln or "Compiling" in ln
                    or "Performance" in ln):
                log(f"build: ptxas {ln.strip()[:150]}")
        check_tensor_core_kernels()

        torch.manual_seed(0)
        timer = Timer(torch)
        rows = []
        for phase in (lambda: phase_ragged(torch, timer,
                                           np.random.RandomState(0)),
                      lambda: phase_flash(torch, timer),
                      lambda: phase_rms(torch, timer),
                      lambda: phase_flash_bwd(torch, timer),
                      lambda: phase_flash_seg(torch, timer),
                      lambda: phase_flash_seg_bwd(torch, timer),
                      lambda: phase_rms_bwd(torch, timer),
                      lambda: phase_fused(torch, timer),
                      lambda: phase_gmm2(torch, timer),
                      lambda: phase_gmm(torch, timer),
                      lambda: phase_tgmm(torch, timer),
                      lambda: phase_scan(torch, timer),
                      lambda: phase_paged(torch, np, timer,
                                          np.random.RandomState(1)),
                      lambda: phase_quant(torch, np, timer,
                                          np.random.RandomState(3))):
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

        counts, serve_stats, model, compiled = phase_serve(torch, np,
                                                           args.layers, card)
        counts = {"serve": counts}
        torch.cuda.empty_cache()
        log(f"serve done at {time.perf_counter() - t_start:.1f} s")
        counts["serve-int8"] = phase_serve_int8(
            torch, np, model, args.layers, card, serve_stats, compiled)[0]
        log(f"serve-int8 done at {time.perf_counter() - t_start:.1f} s")
        counts["serve-eager"] = phase_serve_eager(
            torch, np, model, args.layers, card, compiled)[0]
        del model
        log(f"serve-eager done at {time.perf_counter() - t_start:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        fleet_counts, fleet_row, _ = phase_serve_fleet(
            torch, np, args.layers, card,
            os.path.join(HERE, "chiprun_out", "serve_fleet_logs"))
        counts.update(fleet_counts)
        rows.append(fleet_row)
        log(f"serve-fleet done at {time.perf_counter() - t_start:.1f} s")
        counts["serve-quant"] = phase_serve_quant(torch, np, card)[0]
        log(f"serve-quant done at {time.perf_counter() - t_start:.1f} s")
        # serving before training, as in a serving process
        moe = phase_serve_moe(torch, np, card)
        counts["serve-moe"], counts["serve-moe-unfused"] = moe[0], moe[2]
        log(f"serve-moe done at {time.perf_counter() - t_start:.1f} s")
        counts["serve-ssm"] = phase_serve_ssm(torch, np, card)[0]
        log(f"serve-ssm done at {time.perf_counter() - t_start:.1f} s")
        counts["train"] = phase_train(torch, np, card)[0]
        log(f"train done at {time.perf_counter() - t_start:.1f} s")
        counts["train-moe"] = phase_train_moe(torch, np, card)[0]
        log(f"train-moe done at {time.perf_counter() - t_start:.1f} s")
        cp_counts, hop_row = phase_train_cp(torch, np, card)
        counts.update(cp_counts)
        rows.append(hop_row)
        log(f"train-cp done at {time.perf_counter() - t_start:.1f} s")
        ep_counts, ep_rows = phase_train_moe_ep(torch, np, card)
        counts.update(ep_counts)
        rows.extend(ep_rows)
        log(f"train-moe-ep done at {time.perf_counter() - t_start:.1f} s")
        for r in rows:
            names = r.get("counts", [r["name"]])
            r["launches"] = sum(counts[r["path"]][n] for n in names)
            r["launches_by_path"] = {p: sum(c[n] for n in names)
                                     for p, c in counts.items()}
            assert r["launches"] > 0, \
                f"{r['name']} not on the {r['path']} path"
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "path", "launches_by_path")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(card)
        # call_ms: the whole SPMD call of an exchange kernel (#15-#18),
        # beside ms, its launch alone
        log(json.dumps({"kernels": [
            dict({k: r[k] for k in keys},
                 **({"call_ms": r["call_ms"]} if "call_ms" in r else {}))
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
