"""Continuous-batching decode step (port of
``paddle_tpu/inference/decode_step.py``, dense attention-only Llama).

One call runs the whole serving step over packed ragged tokens — decode
tokens and prompt chunks mixed — : paged-cache writes, ragged paged
attention, norms and MLP, logits, on-device sampling and the speculative
acceptance column. The reference traces it into one donated-buffer XLA
executable; PyTorch runs it eagerly, updating the KV cache in place, with
one host sync per step (the engine reads the sampled tokens).

Dtype flow, as in the reference: ``_rms`` returns the normalized row in
the input dtype TIMES the fp32 norm weight, so from a bf16 model's first
norm on the residual stream and the projections are fp32 (fp32 ``x``
times bf16 ``w``, promoted explicitly by
:func:`paddle_tpu_torch.nn.functional.matmul`). K/V are cast to the cache
dtype on write, so the ragged kernel sees fp32 queries over bf16 pages.

Pad tokens have ``valids = 0`` (attention output exactly 0), write to the
cache's sentinel row, and their sampled token is ignored by the host.

Not ported yet (ROADMAP.md A): MoE layers, SSM layers, quantized KV pages
and weight-only int8.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from paddle_tpu_torch.incubate.nn.functional.fused_ops import (_rotate_neox,
                                                               rope_tables)
from paddle_tpu_torch.inference.attention import ragged_attention_xla
from paddle_tpu_torch.nn.functional import matmul as _mm
from paddle_tpu_torch.nn.functional.norm import rms_norm as _rms
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    ragged_paged_attention)

__all__ = ["bucket", "compiled_capable", "extract_params", "make_step",
           "sample_tokens"]


def bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def compiled_capable(model):
    """None when the step can run ``model`` (a dense Llama stack), else
    the reason it cannot."""
    llama = getattr(model, "llama", None)
    if llama is None or not hasattr(llama, "layers"):
        return "model has no llama-style decoder stack (model.llama)"
    for i, layer in enumerate(llama.layers):
        if hasattr(layer, "mixer"):
            return f"layer {i} is an SSM mixer (hybrid models)"
        mlp = getattr(layer, "mlp", None)
        if not all(hasattr(mlp, a) for a in ("gate_proj", "up_proj",
                                             "down_proj")):
            return f"layer {i} mlp is not a swiglu gate/up/down MLP (MoE)"
    return None


def extract_params(model) -> Dict[str, Any]:
    """The model's own weight tensors (no copies) as the step's params."""
    reason = compiled_capable(model)
    if reason is not None:
        raise ValueError(f"the decode step cannot run this model: {reason}")
    layers = []
    for layer in model.llama.layers:
        att, mlp = layer.self_attn, layer.mlp
        layers.append({
            "ln1": layer.input_layernorm.weight,
            "wq": att.q_proj.weight, "wk": att.k_proj.weight,
            "wv": att.v_proj.weight, "wo": att.o_proj.weight,
            "ln2": layer.post_attention_layernorm.weight,
            "wg": mlp.gate_proj.weight, "wu": mlp.up_proj.weight,
            "wd": mlp.down_proj.weight,
        })
    params = {"embed": model.llama.embed_tokens.weight,
              "norm": model.llama.norm.weight, "layers": layers}
    if model.lm_head is not None:
        params["lm_head"] = model.lm_head.weight
    return params


def _rope(t: torch.Tensor, positions: torch.Tensor, base: float):
    """Neox RoPE on packed tokens ``t [n, heads, d]`` at ``positions``."""
    sin, cos = rope_tables(positions, t.shape[-1], base)
    return _rotate_neox(t, sin[:, None, :], cos[:, None, :])


# 32-bit hash constants (a "lowbias32"-style integer mixer)
_M1, _M2 = 0x7FEB352D, 0x846CA68B
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), split in 16-bit
    halves so no intermediate leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _gumbel(seeds: torch.Tensor, counters: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Gumbel noise ``[s, vocab]`` that is a pure function of
    ``(seed, counter, column)``: integer hashing on whatever device the
    inputs are on, so a row's noise never depends on the batch it rides
    in. (``jax.random.fold_in(PRNGKey(seed), counter)`` cannot be
    reproduced in torch; the contract, not the bits, is ported.)"""
    dev = seeds.device
    s = seeds.long() & _MASK32
    c = counters.long() & _MASK32
    row = _hash32(_hash32(s ^ 0x9E3779B9) ^ c)                  # [s]
    col = torch.arange(vocab, device=dev, dtype=torch.long)
    bits = _hash32((row[:, None] + _hash32(col)[None, :]) & _MASK32)
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))       # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temps, top_ks, top_ps, seeds, counters):
    """On-device sampling: greedy where ``temps <= 0``, else temperature,
    top-k (ties at the k-th value kept), top-p (smallest prefix of sorted
    probabilities reaching ``top_p``, always >= 1 token) and a Gumbel-max
    draw keyed by ``(seed, counter)``. ``logits [s, v]``; the rest ``[s]``.
    Returns int32 ``[s]``."""
    s, v = logits.shape
    lg = logits.float()
    greedy = lg.argmax(dim=-1).to(torch.int32)
    z = lg / temps.clamp_min(1e-6)[:, None]
    k_eff = torch.where((top_ks <= 0) | (top_ks > v),
                        torch.full_like(top_ks, v), top_ks)
    z_desc = torch.sort(z, dim=-1, descending=True).values
    kth = z_desc.gather(1, (k_eff.long() - 1)[:, None])
    z = z.masked_fill(z < kth, float("-inf"))
    p = torch.softmax(z, dim=-1)
    p_sorted, order = torch.sort(p, dim=-1, descending=True, stable=True)
    prior = torch.cumsum(p_sorted, dim=-1) - p_sorted
    keep_sorted = prior < top_ps.clamp(1e-6, 1.0)[:, None]
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    z = z.masked_fill(~keep, float("-inf"))
    sampled = (z + _gumbel(seeds, counters, v)).argmax(dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled.to(torch.int32))


def make_step(cfg, block_size: int, use_kernel: bool = True):
    """The dense decode step (the reference's ``make_step`` signature):

    ``step(width, params, cache, ids, positions, rows, wslots, tables_full,
    row_slots, valids, out_idx, draft_next, n_spec, seeds, counters, temps,
    top_ks, top_ps) -> (tokens [s, V], accepted [s])``

    ``cache`` is the :class:`~paddle_tpu_torch.inference.paged_cache
    .PagedKVCache`, written in place (it stands for the reference's donated
    ``kc, vc``). ``width`` is the block-table width bucket: the per-row
    table is ``tables_full[:, :width][row_slots]``. ``out_idx [s, V]`` are
    each row's output positions in the packed tokens, ``counters [s]`` the
    base sampling counter (column i samples with ``counter + i``),
    ``draft_next [s, V-1]``/``n_spec [s]`` the speculative drafts, and
    ``accepted[r]`` the leading run of ``tokens[r, i] == draft_next[r, i]``.

    ``use_kernel=False`` runs attention through the plain twin instead of
    the ragged kernel — a reference for checking the kernel, not a
    fallback.
    """
    n_heads = cfg.num_attention_heads
    n_kv = cfg.num_key_value_heads
    head_dim = cfg.head_dim
    rope_base = cfg.rope_theta
    eps = cfg.rms_norm_eps
    tied = cfg.tie_word_embeddings
    attend = ragged_paged_attention if use_kernel else ragged_attention_xla

    def _forward(width, params, cache, ids, positions, rows, wslots,
                 tables_full, row_slots, valids):
        t = ids.shape[0]
        tables = tables_full[:, :width][row_slots.long()]
        h = params["embed"][ids.long()]
        wsl = wslots.long()     # pad tokens aim at the sentinel row
        for li, lp in enumerate(params["layers"]):
            x = _rms(h, lp["ln1"], eps)
            q = _mm(x, lp["wq"]).reshape(t, n_heads, head_dim)
            k = _mm(x, lp["wk"]).reshape(t, n_kv, head_dim)
            v = _mm(x, lp["wv"]).reshape(t, n_kv, head_dim)
            qr = _rope(q, positions, rope_base)
            kr = _rope(k, positions, rope_base)
            cache.write(li, kr, v, wsl)
            kc, vc = cache.layer(li)
            att = attend(qr, kc, vc, tables, rows, valids, block_size)
            h = h + _mm(att.reshape(t, n_heads * head_dim), lp["wo"])
            x2 = _rms(h, lp["ln2"], eps)
            h = h + _mm(F.silu(_mm(x2, lp["wg"])) * _mm(x2, lp["wu"]),
                        lp["wd"])
        return _rms(h, params["norm"], eps)

    def _sample_tail(h, params, out_idx, draft_next, n_spec, seeds,
                     counters, temps, top_ks, top_ps):
        s, v_out = out_idx.shape
        hs = h[out_idx.long()].reshape(s * v_out, -1)
        if tied:
            logits = hs @ params["embed"].to(hs.dtype).t()
        else:
            logits = _mm(hs, params["lm_head"])
        col = torch.arange(v_out, dtype=torch.int32, device=h.device)
        tokens = sample_tokens(
            logits, temps.repeat_interleave(v_out),
            top_ks.repeat_interleave(v_out), top_ps.repeat_interleave(v_out),
            seeds.repeat_interleave(v_out),
            (counters[:, None] + col[None, :]).reshape(-1)).reshape(s, v_out)
        if v_out > 1:
            eq = ((tokens[:, :v_out - 1] == draft_next)
                  & (col[None, :v_out - 1] < n_spec[:, None]))
            accepted = torch.cumprod(eq.to(torch.int32), dim=1).sum(dim=1)
        else:
            accepted = torch.zeros((s,), dtype=torch.int32, device=h.device)
        return tokens, accepted.to(torch.int32)

    @torch.no_grad()
    def step(width, params, cache, ids, positions, rows, wslots,
             tables_full, row_slots, valids, out_idx, draft_next, n_spec,
             seeds, counters, temps, top_ks, top_ps):
        h = _forward(width, params, cache, ids, positions, rows, wslots,
                     tables_full, row_slots, valids)
        return _sample_tail(h, params, out_idx, draft_next, n_spec, seeds,
                            counters, temps, top_ks, top_ps)

    return step
