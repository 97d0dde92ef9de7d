"""Continuous-batching decode step (port of
``paddle_tpu/inference/decode_step.py``).

One call runs the whole serving step over packed ragged tokens — decode
tokens and prompt chunks mixed — : paged-cache writes, ragged paged
attention, norms and MLP, logits, on-device sampling and the speculative
acceptance column. The reference traces it into one donated-buffer XLA
executable a bucket signature; the engine runs it as a ``jit.to_static``
program a signature, captured into a CUDA graph and replayed (op by op
under ``jit.enable_to_static(False)``), updating the KV cache in place,
with one host sync per step (the engine reads the sampled tokens). The
step reads no device value on the host, so it captures whole.

Dtype flow, as in the reference: ``_rms`` returns the normalized row in
the input dtype TIMES the fp32 norm weight, so from a bf16 model's first
norm on the residual stream and the projections are fp32 (fp32 ``x``
times bf16 ``w``, promoted explicitly by
:func:`paddle_tpu_torch.nn.functional.matmul`). K/V are cast to the cache
dtype on write, so the ragged kernel sees fp32 queries over bf16 pages.

Pad tokens have ``valids = 0`` (attention output exactly 0), write to the
cache's sentinel row, and their sampled token is ignored by the host.

MoE layers (the reference's compiled MoE step): the gate's index routing
with the bucket-pad rows masked out of it, the sort-based dispatch into an
expert-major buffer and the expert MLP as grouped GEMMs. The buffer is
fp32 (``_rms`` promotes), the expert weights stay bf16 and the gmm/gmm2
kernels widen them as they load them. Under ``moe_grouped_gemm=off`` the
expert MLP is the reference's per-expert einsum arm (``torch.bmm`` over
the buffer at ``c_pad = capacity``, the weights widened to fp32).

SSM layers of a hybrid model (:func:`ssm_layer_step`, shared with the
eager engine): one recurrence step per token from the slot's O(1) state —
the conv window and the fp32 SSD state — read at ``sslots`` and written
back in place. Attention layers index the KV cache by their running count,
so a hybrid cache holds only its attention layers. Pad tokens carry the
sentinel slot ``max_seqs``: the state tensors have one spare row there,
as the KV cache has, which no request owns (the reference drops those
writes with ``mode="drop"``).

Quantized KV pages (``kv_quant="int8"`` or ``"fp8"``, attention-only
models): the cache quantizes K and V rows on the write, with their per-row,
per-head scales landing at the same ``wslots``, and attention reads the
quantized pages through the quantized ragged kernel (its plain twin with
``use_kernel=False``). Weight-only int8 (``extract_params(model,
weight_quant=True)``): the seven dense projections of each attention layer
become ``{"q": int8 [in, out], "s": fp32 [out]}`` and :func:`_mm` computes
``(x @ q) * s``, the int8 weight cast to x's dtype for the product as the
reference writes it (``torch.matmul``, outside any kernel).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.incubate.distributed.models.moe.gate import BaseGate
from paddle_tpu_torch.incubate.nn.functional.fused_ops import (_rotate_neox,
                                                               rope_tables)
from paddle_tpu_torch.inference.attention import ragged_attention_xla
from paddle_tpu_torch.nn.functional import matmul as _matmul
from paddle_tpu_torch.nn.functional.norm import rms_norm as _rms
from paddle_tpu_torch.ops.kernels import grouped_gemm as gg
from paddle_tpu_torch.ops.kernels.quant import (
    ragged_paged_attention_quant, ragged_paged_attention_quant_plain)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    ragged_paged_attention)
from paddle_tpu_torch.ops.kernels.selective_scan import selective_scan_update
from paddle_tpu_torch.quantization import kv as _kvq

__all__ = ["bucket", "compiled_capable", "extract_params",
           "extract_moe_specs", "extract_ssm_specs", "make_step",
           "sample_tokens", "ssm_layer_step", "ssm_params"]


def bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


_MOE_EXPERT_NAMES = ["down_proj.weight", "gate_proj.weight",
                     "up_proj.weight"]


def _is_moe(mlp) -> bool:
    return hasattr(mlp, "gate") and hasattr(mlp, "expert_parameters")


_SSM_MIXER_ATTRS = ("in_proj", "conv_weight", "conv_bias", "dt_bias",
                    "A_log", "D", "norm_weight", "out_proj")


def _is_ssm_layer(layer) -> bool:
    """A hybrid stack's SSM layer: a ``mixer`` instead of ``self_attn``;
    it holds O(1) per-slot state and writes no KV pages."""
    return hasattr(layer, "mixer")


def compiled_capable(model):
    """None when the step can run ``model`` (a Llama stack of dense or MoE
    layers, or a hybrid one with Mamba-2 mixers), else the reason it
    cannot."""
    llama = getattr(model, "llama", None)
    if llama is None or not hasattr(llama, "layers"):
        return "model has no llama-style decoder stack (model.llama)"
    for i, layer in enumerate(llama.layers):
        if _is_ssm_layer(layer):
            if not hasattr(layer, "input_layernorm"):
                return f"layer {i} has no input_layernorm"
            for attr in _SSM_MIXER_ATTRS:
                if not hasattr(layer.mixer, attr):
                    return (f"layer {i} mixer is not a Mamba2-style gated "
                            f"SSD block (no {attr})")
            continue
        mlp = getattr(layer, "mlp", None)
        if _is_moe(mlp):
            names, _ = mlp.expert_parameters()
            if sorted(names) != _MOE_EXPERT_NAMES:
                return (f"layer {i}: MoE experts are not swiglu "
                        f"gate/up/down MLPs (params {sorted(names)})")
            route = getattr(type(mlp.gate), "route_indices", None)
            if route is None or route is BaseGate.route_indices:
                return (f"layer {i}: gate {type(mlp.gate).__name__} has no "
                        f"index-form routing (route_indices)")
        elif not all(hasattr(mlp, a) for a in ("gate_proj", "up_proj",
                                               "down_proj")):
            return f"layer {i} mlp is not a swiglu gate/up/down MLP"
    return None


#: Dense projection leaves that weight-only int8 serving quantizes. The
#: embedding, LM head, final norm, MoE expert stacks and SSM mixers stay
#: full width, as in the reference.
_WQ_NAMES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def _mm(x, w):
    """``x @ w`` with JAX's promotion; an int8 leaf ``{"q": int8 [in, out],
    "s": fp32 [out]}`` computes ``(x @ q) * s`` in x's dtype: the
    per-output-channel dequant after the product, as the reference's
    ``_mm`` does."""
    if isinstance(w, dict):
        y = x @ w["q"].to(x.dtype)
        return (y.float() * w["s"]).to(x.dtype)
    return _matmul(x, w)


def extract_params(model, weight_quant: bool = False) -> Dict[str, Any]:
    """The model's own weight tensors (no copies) as the step's params; an
    MoE layer gives its gate weight and the stacked ``[E, ...]`` expert
    leaves. ``weight_quant=True`` replaces each dense projection of an
    attention layer (:data:`_WQ_NAMES`) with ``{"q": int8, "s": fp32
    [out]}``, per-output-channel abs-max int8
    (:func:`~paddle_tpu_torch.quantization.kv.quantize_weight_int8`)."""
    reason = compiled_capable(model)
    if reason is not None:
        raise ValueError(f"the decode step cannot run this model: {reason}")
    layers = []
    for layer in model.llama.layers:
        if _is_ssm_layer(layer):
            layers.append(ssm_params(layer))
            continue
        att, mlp = layer.self_attn, layer.mlp
        lp = {
            "ln1": layer.input_layernorm.weight,
            "wq": att.q_proj.weight, "wk": att.k_proj.weight,
            "wv": att.v_proj.weight, "wo": att.o_proj.weight,
            "ln2": layer.post_attention_layernorm.weight,
        }
        if _is_moe(mlp):
            names, params = mlp.expert_parameters()
            by_name = dict(zip(names, params))
            lp["moe_gate_w"] = mlp.gate.weight
            lp["moe_wg"] = by_name["gate_proj.weight"]
            lp["moe_wu"] = by_name["up_proj.weight"]
            lp["moe_wd"] = by_name["down_proj.weight"]
        else:
            lp["wg"] = mlp.gate_proj.weight
            lp["wu"] = mlp.up_proj.weight
            lp["wd"] = mlp.down_proj.weight
        if weight_quant:
            with torch.no_grad():
                for name in _WQ_NAMES:
                    if name in lp:
                        q, s = _kvq.quantize_weight_int8(lp[name])
                        lp[name] = {"q": q, "s": s}
        layers.append(lp)
    params = {"embed": model.llama.embed_tokens.weight,
              "norm": model.llama.norm.weight, "layers": layers}
    if model.lm_head is not None:
        params["lm_head"] = model.lm_head.weight
    return params


def extract_moe_specs(model) -> Optional[List[Optional[Dict[str, Any]]]]:
    """Per layer, the MoE routing spec (the gate object, top-k, capacity
    factor, expert count) or None for a dense layer; None for a dense
    model."""
    specs = []
    for layer in model.llama.layers:
        mlp = getattr(layer, "mlp", None)
        specs.append({"gate": mlp.gate,
                      "top_k": int(getattr(mlp.gate, "top_k", 1)),
                      "cf": float(mlp.capacity_factor),
                      "num_experts": int(mlp.num_experts)}
                     if _is_moe(mlp) else None)
    return specs if any(s is not None for s in specs) else None


def ssm_params(layer) -> Dict[str, Any]:
    """An SSM layer's weights (no copies) under the names
    :func:`ssm_layer_step` reads."""
    m = layer.mixer
    return {"ln1": layer.input_layernorm.weight, "ssm_win": m.in_proj.weight,
            "conv_w": m.conv_weight, "conv_b": m.conv_bias,
            "dt_bias": m.dt_bias, "A_log": m.A_log, "D": m.D,
            "norm_w": m.norm_weight, "wout": m.out_proj.weight}


def extract_ssm_specs(model) -> Optional[List[Optional[Dict[str, Any]]]]:
    """Per layer, the SSM geometry (shape constants; the weights ride the
    params) or None for an attention layer; None for a model with no SSM
    layer. The engine sizes the per-slot state from it."""
    specs = []
    for layer in model.llama.layers:
        if not _is_ssm_layer(layer):
            specs.append(None)
            continue
        mcfg = layer.mixer.config
        specs.append({
            "d_inner": int(mcfg.ssm_d_inner),
            "d_state": int(mcfg.ssm_state_size),
            "nheads": int(mcfg.ssm_num_heads),
            "head_dim": int(mcfg.ssm_head_dim),
            "conv_kernel": int(mcfg.ssm_conv_kernel),
            "conv_dim": int(mcfg.ssm_d_inner + 2 * mcfg.ssm_state_size),
        })
    return specs if any(s is not None for s in specs) else None


def _moe_mlp(x2, lp, spec, use_kernel: bool, valid):
    """The MoE MLP at decode shapes (``decode_step.py:352-408``): the
    gate's index routing with ``valid [t]`` masking the bucket-pad rows out
    of it (so that pads, which all share token 0's embedding, can take no
    expert capacity from real tokens), the sort-based dispatch, the expert
    MLP and the combine. The expert MLP is the grouped GEMMs (their plain
    twins with ``use_kernel=False``) when ``moe_grouped_gemm`` takes them
    and the kernels take the dtype; otherwise the reference's per-expert
    einsum arm over the expert-major buffer at ``c_pad = capacity``
    (``torch.bmm``; no kernel of the port's)."""
    t, m = x2.shape
    gate = spec["gate"]
    num_e = spec["num_experts"]
    capacity = gate.capacity(t, spec["cf"], spec["top_k"])
    wg, wu, wd = lp["moe_wg"], lp["moe_wu"], lp["moe_wd"]
    ffn = wg.shape[-1]
    scores = torch.matmul(x2, lp["moe_gate_w"].to(x2.dtype))
    e_idx, slot, w, keep, _aux = gate.route_indices(scores.float(), capacity,
                                                    valid=valid)
    ct = torch.promote_types(x2.dtype, wg.dtype)
    fast = (gg.fast_path_enabled()
            and gg.eligible(num_e, capacity, m, ffn, ct)
            and gg.eligible(num_e, capacity, ffn, m, ct))
    c_pad = gg.padded_capacity(capacity) if fast else capacity
    x_buf, counts, dest = gg.sorted_dispatch(x2.to(ct), e_idx, slot, keep,
                                             num_e, c_pad)
    if fast:
        y_buf = gg.expert_mlp(x_buf, counts, wg, wu, wd,
                              plain=not use_kernel)
    else:
        xb = x_buf.reshape(num_e, capacity, m)
        act = F.silu(torch.bmm(xb, wg.to(ct))) * torch.bmm(xb, wu.to(ct))
        y_buf = torch.bmm(act, wd.to(ct)).reshape(num_e * capacity, m)
    return gg.sorted_combine(y_buf, dest, w, keep, t).to(x2.dtype)


def ssm_layer_step(h, lp, spec, conv_state, ssm_state, eps):
    """One single-token step of an SSM mixer layer on packed rows
    (``decode_step.py:411-449``), shared by the compiled step and the
    eager engine. ``h [s, hidden]``; ``conv_state [s, k-1, conv_dim]`` the
    raw conv window tail; ``ssm_state [s, nheads, d_state, head_dim]``
    fp32. Returns ``(h', conv_state', ssm_state')``."""
    s = h.shape[0]
    di, ds = spec["d_inner"], spec["d_state"]
    nh, hd = spec["nheads"], spec["head_dim"]
    cdim = spec["conv_dim"]
    x = _rms(h, lp["ln1"], eps)
    zxbcdt = _mm(x, lp["ssm_win"])                  # [s, 2di+2ds+nh]
    z = zxbcdt[:, :di]
    xbc = zxbcdt[:, di:di + cdim]
    dt_raw = zxbcdt[:, di + cdim:di + cdim + nh]
    # causal depthwise conv: slide the carried window one position
    window = torch.cat([conv_state.to(xbc.dtype), xbc[:, None, :]], dim=1)
    conv = ((window * lp["conv_w"].t().to(xbc.dtype)[None]).sum(dim=1)
            + lp["conv_b"].to(xbc.dtype))
    xconv = F.silu(conv)                            # [s, conv_dim]
    x_t = xconv[:, :di].reshape(s, nh, hd)
    b_t = xconv[:, di:di + ds]
    c_t = xconv[:, di + ds:]
    a = dt_raw.float() + lp["dt_bias"].float()
    dt = torch.logaddexp(a, torch.zeros_like(a))    # jax.nn.softplus
    A = -torch.exp(lp["A_log"].float())
    y, ssm_new = selective_scan_update(ssm_state, x_t, dt, A, b_t, c_t)
    y = y + x_t * lp["D"].to(y.dtype)[None, :, None]
    y = y.reshape(s, di)
    y = _rms(y * F.silu(z), lp["norm_w"], eps)
    h = h + _mm(y.to(lp["wout"].dtype), lp["wout"]).to(h.dtype)
    return h, window[:, 1:, :], ssm_new


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


def make_step(cfg, block_size: int, use_kernel: bool = True, moe=None,
              ssm=None, kv_quant: Optional[str] = None):
    """The decode step (the reference's hybrid ``make_step`` signature,
    with ``cache`` for its ``kc, vc``):

    ``step(width, params, cache, sstate, ids, positions, rows, wslots,
    sslots, tables_full, row_slots, valids, out_idx, draft_next, n_spec,
    seeds, counters, temps, top_ks, top_ps) -> (tokens [s, V],
    accepted [s])``

    ``cache`` is the :class:`~paddle_tpu_torch.inference.paged_cache
    .PagedKVCache`, written in place (it stands for the reference's donated
    ``kc, vc``). ``width`` is the block-table width bucket: the per-row
    table is ``tables_full[:, :width][row_slots]``. ``out_idx [s, V]`` are
    each row's output positions in the packed tokens, ``counters [s]`` the
    base sampling counter (column i samples with ``counter + i``),
    ``draft_next [s, V-1]``/``n_spec [s]`` the speculative drafts, and
    ``accepted[r]`` the leading run of ``tokens[r, i] == draft_next[r, i]``.

    ``moe`` is :func:`extract_moe_specs`'s list for a model with MoE
    layers. ``use_kernel=False`` runs attention and the grouped GEMMs
    through their plain twins instead of the kernels — a reference for
    checking the kernels, not a fallback.

    ``ssm`` is :func:`extract_ssm_specs`'s list for a hybrid model. Its
    per-slot state ``sstate`` (a list over layers: ``{"conv": [max_seqs +
    1, k-1, conv_dim], "ssm": [max_seqs + 1, nheads, d_state, head_dim]}``
    for an SSM layer, None for an attention layer; the last row is the
    pads' sentinel) is read at the per-token state slots ``sslots [t]`` and
    updated in place. A model with no SSM layer passes None for both.

    ``kv_quant`` (``"int8"`` or ``"fp8"``, attention-only models) says the
    cache is quantized (``cache.quant`` must agree): its write quantizes K
    and V right before the scatter, the scales riding the same ``wslots``,
    and attention reads the pages and scales through the quantized ragged
    kernel (its twin with ``use_kernel=False``). It does not compose with
    ``ssm``, as in the reference, where the engine turns it off first.
    """
    if kv_quant is not None and ssm is not None:
        raise ValueError("kv_quant does not compose with hybrid-SSM steps; "
                         "the engine disables it first")
    n_heads = cfg.num_attention_heads
    n_kv = cfg.num_key_value_heads
    head_dim = cfg.head_dim
    rope_base = cfg.rope_theta
    eps = cfg.rms_norm_eps
    tied = cfg.tie_word_embeddings
    attend = ragged_paged_attention if use_kernel else ragged_attention_xla
    attend_quant = (ragged_paged_attention_quant if use_kernel
                    else ragged_paged_attention_quant_plain)

    def _forward(width, params, cache, sstate, ids, positions, rows, wslots,
                 sslots, tables_full, row_slots, valids):
        t = ids.shape[0]
        tables = tables_full[:, :width][row_slots.long()]
        h = params["embed"][ids.long()]
        wsl = wslots.long()     # pad tokens aim at the sentinel row
        kv_li = 0               # attention layers index the cache in order
        for li, lp in enumerate(params["layers"]):
            sspec = ssm[li] if ssm is not None else None
            if sspec is not None:
                st, sl = sstate[li], sslots.long()
                h, conv_new, ssm_new = ssm_layer_step(
                    h, lp, sspec, st["conv"][sl], st["ssm"][sl], eps)
                st["conv"].index_copy_(0, sl, conv_new.to(st["conv"].dtype))
                st["ssm"].index_copy_(0, sl, ssm_new)
                continue
            x = _rms(h, lp["ln1"], eps)
            q = _mm(x, lp["wq"]).reshape(t, n_heads, head_dim)
            k = _mm(x, lp["wk"]).reshape(t, n_kv, head_dim)
            v = _mm(x, lp["wv"]).reshape(t, n_kv, head_dim)
            qr = _rope(q, positions, rope_base)
            kr = _rope(k, positions, rope_base)
            cache.write(kv_li, kr, v, wsl)   # quantizes when kv_quant
            kc, vc, ksc, vsc = cache.layer(kv_li)
            kv_li += 1
            if kv_quant is not None:
                att = attend_quant(qr, kc, vc, ksc, vsc, tables, rows,
                                   valids, block_size)
            else:
                att = attend(qr, kc, vc, tables, rows, valids, block_size)
            h = h + _mm(att.reshape(t, n_heads * head_dim), lp["wo"])
            x2 = _rms(h, lp["ln2"], eps)
            spec = moe[li] if moe is not None else None
            if spec is not None:
                # valids == 0 marks the bucket pads
                h = h + _moe_mlp(x2, lp, spec, use_kernel, valids > 0)
            else:
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
    def step(width, params, cache, sstate, ids, positions, rows, wslots,
             sslots, tables_full, row_slots, valids, out_idx, draft_next,
             n_spec, seeds, counters, temps, top_ks, top_ps):
        if cache.quant != kv_quant:
            raise ValueError(f"the step was made for kv_quant={kv_quant!r} "
                             f"but the cache holds quant={cache.quant!r}")
        h = _forward(width, params, cache, sstate, ids, positions, rows,
                     wslots, sslots, tables_full, row_slots, valids)
        return _sample_tail(h, params, out_idx, draft_next, n_spec, seeds,
                            counters, temps, top_ks, top_ps)

    return step
