#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: Python, torch and CUDA versions, the card's name and power
   limit (``nvidia-smi``);
2. build: every kernel under ``paddle_tpu_torch/csrc`` compiled by nvcc
   from this checkout;
3. kernels: each kernel's wrapper on CUDA tensors at the serving slice's
   shapes (Llama-3-8B widths: head_dim 128, 32:8 heads, hidden 4096) held
   against its plain PyTorch twin on the same inputs, then timed beside
   the twin, the PyTorch library call that computes the same function
   (where one exists) and the least time the card could take;
4. serve, the port's main path: ``GenerationEngine.generate`` serving 8
   requests (prompts of 32..1024 tokens, 32 new tokens each, 6 greedy and
   2 sampled) on a Llama-3-8B-width model with seeded random weights,
   then ``LlamaForCausalLM.forward`` scoring the prompts. Kernel launch
   counts are zeroed just before and read just after. Checks: finish
   reasons, no page leak, ragged launches == steps x layers, a second run
   bitwise equal (run under ``torch.profiler`` for a device-time
   breakdown), greedy tokens >= 99% equal to the same engine with the
   plain attention twin, one decoder layer through the kernels equal to
   its plain-twin run at the bf16 tier, and the kernel forward no further
   from an fp32 reference forward than the plain-twin forward is;
5. the ``kernels`` JSON line, then the result line.

fp32 matmuls run without TF32 throughout (``allow_tf32 = False``), so the
twins and the serving step's fp32 projections are full fp32.

It imports nothing of JAX or of the JAX package ``paddle_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
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
                max_abs_err=err, tolerance=tol,
                ms=timer.ms(lambda: rp.ragged_paged_attention(*args)),
                plain_ms=timer.ms(lambda: rp.ragged_paged_attention_plain(
                    *args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"q fp32 [{t}, {hq}, {d}], bf16 pages, block 64")


def phase_flash(torch, timer):
    """Causal bf16 [1, 2048, 32|8, 128], and a ragged length (1000)."""
    import torch.nn.functional as F
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
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    except TypeError:  # torch without enable_gqa: repeat outside the timing
        kr, vr = (x.repeat_interleave(4, dim=1) for x in (kt, vt))

        def lib():
            return F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)
    pairs = s * (s + 1) // 2
    flops = 4 * 32 * 128 * pairs
    nbytes = (q.numel() * 2 + k.numel() * 2 * 2 + q.numel() * 2 + 32 * s * 4)
    b_ms, b_by = bound(nbytes, flops, "bf16")
    return dict(name="flash_attention_fwd", route="cuda",
                source="paddle_tpu_torch/csrc/flash_attention.cu",
                replaces="paddle_tpu/ops/pallas/flash_attention.py:130",
                max_abs_err=max(res, err), tolerance=tol,
                ms=timer.ms(lambda: fa.flash_attention_with_lse(q, k, v,
                                                                True)),
                plain_ms=timer.ms(lambda: fa.flash_attention_plain(q, k, v,
                                                                   True)),
                bound_ms=b_ms, bound_by=b_by, library_ms=timer.ms(lib),
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
                max_abs_err=err, tolerance="rtol=atol=2e-2 (bf16 output)",
                ms=timer.ms(lambda: rn.rms_norm(x, w, 1e-5)),
                plain_ms=timer.ms(lambda: rn.rms_norm_plain(x, w, 1e-5)),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                shape="x bf16 [2048, 4096], w fp32 [4096]")


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
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    from paddle_tpu_torch.ops import kernels
    cfg = llama3_8b_config(dtype="bfloat16", num_hidden_layers=layers)
    log(f"serve: Llama-3-8B widths (hidden 4096, ffn 14336, vocab 128256, "
        f"rope theta 5e5, GQA 32:8), {layers} of 32 layers, bf16, seeded "
        f"random weights")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"serve: model built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    # ---- the main path: counts zeroed just before, read just after
    kernels.reset_launch_counts()
    eng, prompts, out, steps, wall = serve(torch, model, np)
    scored = [model(torch.tensor([p], device=model.device)) for p in prompts]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"serve: main-path launches {counts}")

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
    out2 = profile_serve(torch, model, np, wall)
    assert out2 == out, "second run differs"
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
    """The model's flash-attention and RMSNorm calls go to the plain
    twins inside the block (a reference, never a fallback)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    orig = fa.flash_attention, rn.rms_norm
    fa.flash_attention = lambda q, k, v, c=False: \
        fa.flash_attention_plain(q, k, v, c)[0]
    rn.rms_norm = rn.rms_norm_plain
    try:
        yield
    finally:
        fa.flash_attention, rn.rms_norm = orig


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


def profile_serve(torch, model, np, plain_wall):
    """A repeat of the engine run under ``torch.profiler``: device time
    by kernel, and the kernels' summed time as a share of the wall time
    of this run and of the same run without the profiler
    (``plain_wall``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, out, _, wall = serve(torch, model, np)
        torch.cuda.synchronize()
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
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log("serve profile: the profiler saw no device time (not measured)")
        return out
    log(f"serve profile: kernels {busy:.3f} s over a profiled wall of "
        f"{wall:.3f} s ({busy / wall:.3f}) and an unprofiled wall of "
        f"{plain_wall:.3f} s ({busy / plain_wall:.3f})")
    for us, n, name in rows[:12]:
        log(f"serve profile: {us / 1e3:10.2f} ms {100 * us / 1e6 / busy:6.2f}% "
            f"x{n:<6d} {name[:90]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of the served model (of 32)")
    args = ap.parse_args()
    if not __debug__:
        print("chip_smoke: the checks are asserts; run without -O",
              file=sys.stderr)
        return 2
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
        regs = [ln.strip() for ln in _build.ptxas_report().splitlines()
                if "registers" in ln]
        log(f"build: ptxas {len(regs)} kernels, e.g. {regs[:1]}")

        torch.manual_seed(0)
        timer = Timer(torch)
        rows = [phase_ragged(torch, timer, np.random.RandomState(0)),
                phase_flash(torch, timer), phase_rms(torch, timer)]
        for r in rows:
            log(f"kernel {r['name']}: {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3g} (tol {r['tolerance']}), "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}) on {card}")
        del timer

        counts, perf = phase_serve(torch, np, args.layers, card)
        for r in rows:
            r["launches"] = counts[r["name"]]
            assert r["launches"] > 0, f"{r['name']} not on the main path"
        keys = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
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
