"""Generation engine: continuous batching over a paged KV cache (port of
``paddle_tpu/inference/engine.py``).

Host side: the request queue, slot and block allocation, chunked-prefill
scheduling and finish bookkeeping. Two modes share it:

* ``mode="compiled"``: one call of the decode step
  (:mod:`paddle_tpu_torch.inference.decode_step`) per engine step over
  packed ragged tokens — each decoding sequence contributes its pending
  token, the remaining token budget goes to prompt chunks — padded to
  power-of-two buckets (token count, row count, output count, table width)
  as in the reference, so a step's shapes depend only on its bucket. Per
  step the host uploads the packed int32 and float32 inputs in one copy
  each and reads the sampled tokens back in one sync.
* ``mode="eager"``: the reference's parity oracle. Each prompt is
  prefilled whole at admission through the model's own layers (flash
  attention), then every step walks the layers in Python for one token per
  sequence, attention through ``paged_attention_decode`` (the paged decode
  kernel), and samples on the host with numpy from one
  ``RandomState(0)`` per engine, as the reference does.

``mode="auto"`` takes the compiled step when it can run the model and
warns once and walks eagerly otherwise. ``use_kernel=False`` puts the
attention kernel's plain twin in the step (ragged attention when
compiled, paged decode attention when eager): a reference for checking
the kernels, not a fallback.

Hybrid attention+SSM models (``models/ssm.py``) run in both modes. Their
KV cache holds only the attention layers; each SSM layer keeps per-slot
recurrent state (the conv window in the model dtype, the SSD state in
fp32), one spare row past ``max_seqs`` taking the pad tokens' writes. Both
modes prefill a hybrid request at admission — the chunked scan over the
whole prompt installs the final state at the slot — and sample its first
token there; every later step is a single-token recurrence, and a slot's
state is zeroed when its request finishes or is evicted.

The quantized memory plane, as in the reference: ``kv_quant`` (``"int8"``,
``"fp8"``, ``"auto"``/``"on"`` = int8; default the ``serve_kv_quant`` flag)
stores the KV pages in one byte with per-row, per-head fp32 scales, which
the compiled step reads through the quantized ragged kernel;
``weight_quant`` (default ``serve_weight_quant``) runs the compiled step's
dense projections from per-output-channel int8 weights. Both are features
of the compiled step: eager mode turns both off, and a hybrid model turns
``kv_quant`` off, each with a one-time warning, and serves on. The engine
exposes ``kv_quant``, ``weight_quant`` and ``cache.quant``.

The serving loop's API, as in the reference (``engine.py:419-520,
595-629``): :meth:`~GenerationEngine.reap_finished` returns every request
finished since the last reap, :attr:`~GenerationEngine.num_active` counts
the slots in use, :meth:`~GenerationEngine.estimated_blocks` is the
admission estimate, and a request with ``paused`` set keeps its slot and
pages and contributes no tokens (stream backpressure). A prefill→decode
handoff leaves one engine with :meth:`~GenerationEngine.export_request` and
enters another with :meth:`~GenerationEngine.import_request`
(``inference/kv_handoff.py``), a hybrid's per-slot state with it.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item, in both modes and for hybrids): speculative decode
(``spec_tokens > 0``), the prefix cache, the host KV tier; so
:meth:`~GenerationEngine.spillable_blocks`,
:meth:`~GenerationEngine.spill_paused` and
:meth:`~GenerationEngine.release_prefix_cache` are 0.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.framework.dtype import to_torch_dtype
from paddle_tpu_torch.incubate.nn import functional as F_inc
from paddle_tpu_torch.incubate.nn.functional.fused_ops import rope_tables
from paddle_tpu_torch.inference import decode_step as _ds
from paddle_tpu_torch.inference.attention import paged_attention_decode
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops.kernels import paged_attention as _paged
from paddle_tpu_torch.quantization import kv as _kvq

__all__ = ["GenerationEngine", "GenerationRequest"]

# one warning per distinct reason per process, as in the reference: the
# eager fallback of mode="auto" is loud exactly once
_warned_fallbacks: set = set()


def _warn_once(what: str, message: str) -> None:
    """One warning per distinct (feature, message) per process: the eager
    fallback of ``mode="auto"``, and an option the engine turns off."""
    if (what, message) in _warned_fallbacks:
        return
    _warned_fallbacks.add((what, message))
    warnings.warn(f"{what}: {message}", RuntimeWarning, stacklevel=3)


def _warn_fallback(what: str, reason: str) -> None:
    _warn_once(what, f"falling back to the eager path — {reason}")


class GenerationRequest:
    def __init__(self, request_id, input_ids, max_new_tokens=32,
                 temperature=0.0, top_k=0, top_p=1.0, eos_token_id=None,
                 seed=None):
        self.request_id = request_id
        self.input_ids = [int(t) for t in np.asarray(input_ids).reshape(-1)]
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = int(top_k)        # 0 = no top-k truncation
        self.top_p = float(top_p)      # 1.0 = no nucleus truncation
        self.eos_token_id = eos_token_id
        self.seed = seed               # None: engine assigns at admission
        self.output_ids: List[int] = []
        self.slot: Optional[int] = None
        self.finished = False
        # "eos" | "length" | "cache_exhausted" | "rejected" | an eviction
        # reason given to evict() | None
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self._prompt_pos = 0           # prompt tokens written
        # a paused request keeps its slot and KV pages but contributes no
        # tokens (the server's stream backpressure)
        self.paused = False


def _unported(option: str, item: str):
    return NotImplementedError(
        f"GenerationEngine({option}) is not ported to paddle_tpu_torch yet "
        f"(ROADMAP.md {item})")


class GenerationEngine:
    def __init__(self, model, max_seqs=8, max_seq_len=2048, block_size=64,
                 num_blocks=None, mode="auto", prefill_chunk=64,
                 max_tokens_per_step=None, token_bucket_floor=8,
                 spec_tokens=None, prefix_cache=None, kv_quant=None,
                 weight_quant=None, host_tier=None, use_kernel=True):
        if mode not in ("auto", "compiled", "eager"):
            raise ValueError(f"mode must be 'auto', 'compiled' or 'eager', "
                             f"got {mode!r}")
        llama = getattr(model, "llama", None)
        if llama is None or not hasattr(llama, "layers"):
            raise NotImplementedError(
                "GenerationEngine: model has no llama-style decoder stack "
                "(model.llama); only Llama and hybrid SSM models are ported "
                "(ROADMAP.md A.8/A.9)")
        reason = _ds.compiled_capable(model)
        if mode == "auto":
            mode = "compiled" if reason is None else "eager"
            if reason is not None:
                _warn_fallback("compiled decode", reason)
        elif mode == "compiled" and reason is not None:
            raise NotImplementedError(
                f"GenerationEngine(mode='compiled'): {reason} (ROADMAP.md "
                f"A.8/A.9)")
        for name, value, default, item in (
                ("spec_tokens", spec_tokens, "serve_spec_tokens", "A.6"),
                ("prefix_cache", prefix_cache, "serve_prefix_cache", "A.6"),
                ("host_tier", host_tier, "serve_kv_host_tier", "A.7")):
            if value is None:
                value = flags.flag(default)
            if value not in (None, False, 0, "off", "none"):
                raise _unported(f"{name}={value!r}", item)
        if kv_quant is None:
            kv_quant = flags.flag("serve_kv_quant")
        self.kv_quant = _kvq.resolve_mode(kv_quant)
        if weight_quant is None:
            weight_quant = flags.flag("serve_weight_quant")
        self.weight_quant = bool(weight_quant)
        self.model = model
        cfg = model.config
        self.cfg = cfg
        self.mode = mode
        self.device = model.device
        self.use_kernel = use_kernel
        blocks_per_seq = -(-max_seq_len // block_size)
        num_blocks = num_blocks or max_seqs * blocks_per_seq
        self.max_seq_len = max_seq_len
        # hybrid stacks: SSM layers hold per-slot state instead of KV
        # pages, so the paged cache is sized by the attention layers only
        self._ssm_specs = _ds.extract_ssm_specs(model)
        self.is_hybrid = self._ssm_specs is not None
        n_kv_layers = cfg.num_hidden_layers
        if self.is_hybrid:
            n_kv_layers = sum(1 for sp in self._ssm_specs if sp is None)
            if self.kv_quant is not None:
                _warn_once(
                    "kv quant",
                    "hybrid-SSM steps carry recurrent state beside the KV "
                    "pools and their scan state is full-width; disabling "
                    "quantized KV pages for hybrid models")
                self.kv_quant = None
        if mode == "eager":
            # quantized pools and int8 weights are compiled-step features
            if self.kv_quant is not None:
                _warn_once(
                    "kv quant",
                    "eager decode reads full-width pages "
                    "(paged_attention_decode has no fused dequant); "
                    "disabling quantized KV pages in eager mode")
                self.kv_quant = None
            if self.weight_quant:
                _warn_once(
                    "weight quant",
                    "weight-only int8 lives in the compiled step's "
                    "extracted params; the eager walk uses the model's own "
                    "full-width weights — disabling")
                self.weight_quant = False
        dtype = to_torch_dtype(cfg.dtype)
        self.cache = PagedKVCache(
            n_kv_layers, num_blocks, block_size,
            cfg.num_key_value_heads, cfg.head_dim, max_seqs, dtype=dtype,
            blocks_per_seq=_ds.bucket(blocks_per_seq), device=self.device,
            quant=self.kv_quant)
        # per-slot recurrent state, [max_seqs + 1, ...]: the conv window in
        # the model dtype, the SSD state fp32; the last row is the pads'
        self._sstate = None
        if self.is_hybrid:
            self._sstate = [
                None if sp is None else {
                    "conv": torch.zeros(
                        (max_seqs + 1, sp["conv_kernel"] - 1,
                         sp["conv_dim"]), dtype=dtype, device=self.device),
                    "ssm": torch.zeros(
                        (max_seqs + 1, sp["nheads"], sp["d_state"],
                         sp["head_dim"]), dtype=torch.float32,
                        device=self.device)}
                for sp in self._ssm_specs]
        # sin/cos [1, max_seq_len, 1, head_dim] for RoPE at explicit
        # positions (engine.py:130-141): the training model's table,
        # extended to the serving max length
        sin, cos = rope_tables(torch.arange(max_seq_len, device=self.device),
                               cfg.head_dim, cfg.rope_theta)
        self._sin, self._cos = sin[None, :, None, :], cos[None, :, None, :]
        self._requests: Dict[object, GenerationRequest] = {}
        self._slot_req: Dict[int, GenerationRequest] = {}
        self._rng = np.random.RandomState(0)   # eager host sampling
        self.max_seqs = max_seqs
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_tokens_per_step = int(max_tokens_per_step
                                       or max_seqs + self.prefill_chunk)
        self._tok_floor = max(1, int(token_bucket_floor))
        self._seed_counter = 0
        self._reaped: List[GenerationRequest] = []
        self.stats = {"steps": 0, "step_time_s": 0.0, "decode_tokens": 0,
                      "prefill_tokens": 0, "occupancy_sum": 0.0,
                      "decode_rows": 0}
        if mode == "compiled":
            self._params = _ds.extract_params(
                model, weight_quant=self.weight_quant)
            self._dstep = _ds.make_step(cfg, block_size,
                                        use_kernel=use_kernel,
                                        moe=_ds.extract_moe_specs(model),
                                        ssm=self._ssm_specs,
                                        kv_quant=self.kv_quant)

    # -- request lifecycle ---------------------------------------------
    def _admissible(self, request: GenerationRequest) -> bool:
        """Whether the request can EVER be admitted (a prompt past the
        serving max length or the whole pool would spin forever)."""
        n = len(request.input_ids)
        if n == 0 or n > self.max_seq_len:
            return False
        return -(-n // self.cache.block_size) <= self.cache.num_blocks

    def _reject(self, request: GenerationRequest, msg: str) -> None:
        request.finished = True
        request.finish_reason = "rejected"
        request.error = msg

    def add_request(self, request: GenerationRequest) -> bool:
        slot = self.cache.allocate_slot()
        if slot is None:
            return False
        if not self.cache.ensure_capacity(slot, len(request.input_ids)):
            self.cache.free_slot(slot)
            return False
        request.slot = slot
        if request.seed is None:
            request.seed = self._seed_counter
            self._seed_counter += 1
        self._requests[request.request_id] = request
        self._slot_req[slot] = request
        request._prompt_pos = 0
        self.cache.seq_lens[slot] = 0
        if self.is_hybrid:
            # both modes: the chunked scan over the whole prompt installs
            # the final state at the slot; decode is then a recurrence
            self._prefill(request)
        elif self.mode == "eager":
            self._prefill(request)
        return True

    def _finish(self, req: GenerationRequest, reason: str) -> None:
        req.finished = True
        if req.finish_reason is None:
            req.finish_reason = reason
        if self._sstate is not None:
            # completions and evictions alike hand the slot back zeroed: a
            # readmitted slot never sees an earlier request's history
            self._zero_slot_state(req.slot)
        self.cache.free_slot(req.slot)
        del self._slot_req[req.slot]
        self._requests.pop(req.request_id, None)
        self._reaped.append(req)

    def evict(self, request_id, reason: str = "evicted") -> bool:
        """Finish an active request now and free its pages (and zero its
        SSM state); False for an unknown id."""
        req = self._requests.get(request_id)
        if req is None:
            return False
        self._finish(req, reason)
        return True

    def reap_finished(self) -> List[GenerationRequest]:
        """Return (and clear) every request finished since the last reap:
        completions, evictions and mid-step exhaustion alike."""
        out, self._reaped = self._reaped, []
        return out

    @property
    def num_active(self) -> int:
        return len(self._slot_req)

    def estimated_blocks(self, req: GenerationRequest) -> int:
        """Admission estimate: KV blocks for the whole prompt and the full
        requested output, capped at the serving max length (no prefix
        cache to peek, A.6)."""
        total = min(len(req.input_ids) + int(req.max_new_tokens),
                    self.max_seq_len)
        return -(-total // self.cache.block_size)

    def spillable_blocks(self) -> int:
        """Device blocks a spill pass could free: 0 without a host tier
        (A.7)."""
        return 0

    def spill_paused(self, max_blocks: Optional[int] = None) -> int:
        """Park paused requests' pages in the host tier: 0 blocks freed
        without one (A.7)."""
        return 0

    def release_prefix_cache(self) -> int:
        """Drop the prefix index's page holds: 0 without an index (A.6)."""
        return 0

    def export_request(self, request_id):
        """Handoff, sending side: the request's KV pages, generation state
        and refcounts as one record (:func:`~paddle_tpu_torch.inference.
        kv_handoff.export_handoff`); None for an unknown or mid-prefill
        request. The caller evicts with reason ``"handoff"`` after it."""
        from paddle_tpu_torch.inference import kv_handoff
        return kv_handoff.export_handoff(self, request_id)

    def import_request(self, record, request=None):
        """Handoff, receiving side: install a record as an already
        prefilled request (:func:`~paddle_tpu_torch.inference.kv_handoff.
        install_handoff`); None when no slot or blocks are free."""
        from paddle_tpu_torch.inference import kv_handoff
        return kv_handoff.install_handoff(self, record, request=request)

    def _emit_token(self, req: GenerationRequest, tok: int) -> bool:
        """Append a sampled token and settle eos/length; True when the
        request finished (its pages are already back on the free list).
        Capacity for the next token is reserved after every finish of the
        step, so one sequence's eos can save a neighbour from
        ``cache_exhausted``."""
        req.output_ids.append(tok)
        self.stats["decode_tokens"] += 1
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(req, "eos")
            return True
        if len(req.output_ids) >= req.max_new_tokens:
            self._finish(req, "length")
            return True
        return False

    def _reserve_next(self, req: GenerationRequest) -> None:
        if not self.cache.ensure_capacity(
                req.slot, int(self.cache.seq_lens[req.slot]) + 1):
            self._finish(req, "cache_exhausted")

    # -- hybrid SSM state ----------------------------------------------
    def _zero_slot_state(self, slot: int) -> None:
        for st in self._sstate:
            if st is not None:
                st["conv"][slot].zero_()
                st["ssm"][slot].zero_()

    def export_slot_sstate(self, slot: int):
        """One slot's recurrent state, ``[{"layer", "conv", "ssm"}, ...]``
        for each SSM layer (copies, on the engine's device), the SSM half
        of a handoff record; None for an attention-only engine."""
        if self._sstate is None:
            return None
        return [{"layer": li, "conv": st["conv"][slot].clone(),
                 "ssm": st["ssm"][slot].clone()}
                for li, st in enumerate(self._sstate) if st is not None]

    def install_slot_sstate(self, slot: int, planes) -> None:
        """Install exported state planes at ``slot``; both ends run one
        model, so the planes carry absolute layer indices."""
        for p in planes:
            st = self._sstate[int(p["layer"])]
            for name in ("conv", "ssm"):
                st[name][slot] = torch.as_tensor(p[name]).to(
                    st[name].device, st[name].dtype)

    def ssm_state_bytes(self) -> int:
        """Bytes of per-slot SSM state (conv windows and SSD states over
        the SSM layers and the ``max_seqs`` slots; the pads' spare row is
        not counted); 0 for an attention-only model."""
        if self._sstate is None:
            return 0
        return sum(a[0].numel() * a.element_size() * self.max_seqs
                   for st in self._sstate if st is not None
                   for a in st.values())

    # -- the model walk (eager mode, and every hybrid prefill) ----------
    def _rope(self, q, k, positions):
        """The training model's fused RoPE op at explicit positions."""
        return F_inc.fused_rotary_position_embedding(
            q, k, sin=self._sin, cos=self._cos, position_ids=positions,
            use_neox_rotary_style=True,
            rotary_emb_base=self.cfg.rope_theta)[:2]

    def _layer_kv(self, layer, h):
        cfg = self.cfg
        b, s, _ = h.shape
        x = layer.input_layernorm(h)
        att = layer.self_attn
        q = att.q_proj(x).reshape(b, s, cfg.num_attention_heads,
                                  cfg.head_dim)
        k = att.k_proj(x).reshape(b, s, cfg.num_key_value_heads,
                                  cfg.head_dim)
        v = att.v_proj(x).reshape(b, s, cfg.num_key_value_heads,
                                  cfg.head_dim)
        return q, k, v

    def _finish_layer(self, layer, h, att_out):
        b, s = att_out.shape[0], att_out.shape[1]
        h = h + layer.self_attn.o_proj(att_out.reshape(
            b, s, self.cfg.num_attention_heads * self.cfg.head_dim))
        return h + layer.mlp(layer.post_attention_layernorm(h))

    @torch.no_grad()
    def _prefill(self, req: GenerationRequest) -> None:
        """Run the whole prompt at admission (``engine.py:551-575`` and,
        for hybrids, :653-698): attention layers write their K/V pages and
        attend causally through flash attention; SSM layers run the
        chunked scan and install the final (conv, SSD) state at the slot.
        The first token samples here."""
        slot = req.slot
        n = len(req.input_ids)
        dev = self.device
        ids = torch.tensor([req.input_ids], dtype=torch.long, device=dev)
        positions = torch.arange(n, device=dev)[None, :]
        slots = torch.from_numpy(self.cache.slot_mapping(slot, 0, n)).to(dev)
        model = self.model.llama
        h = model.embed_tokens(ids)
        kv_li = 0
        for li, layer in enumerate(model.layers):
            if self._sstate is not None and self._sstate[li] is not None:
                out, conv_st, ssm_st = layer.mixer.forward_with_state(
                    layer.input_layernorm(h))
                st = self._sstate[li]
                st["conv"][slot] = conv_st[0].to(st["conv"].dtype)
                st["ssm"][slot] = ssm_st[0]
                h = h + out
                continue
            q, k, v = self._layer_kv(layer, h)
            qr, kr = self._rope(q, k, positions)
            self.cache.write(kv_li, kr[0], v[0], slots)
            kv_li += 1
            out = scaled_dot_product_attention(qr, kr, v, is_causal=True,
                                               training=False)
            h = self._finish_layer(layer, h, out)
        logits = self.model.logits(model.norm(h)[:, -1])
        self.cache.seq_lens[slot] = n
        req._prompt_pos = n
        self.stats["prefill_tokens"] += n
        if not self._emit(req, logits[0]):
            self._reserve_next(req)

    def _sample_host(self, req: GenerationRequest, arr: np.ndarray) -> int:
        """Host numpy sampling (``engine.py:700-722``): temperature, top-k
        and top-p per request, drawn from the engine's ``RandomState(0)``,
        so that the same logits draw what the JAX eager engine draws."""
        if req.temperature and req.temperature > 0:
            z = arr / req.temperature
            if req.top_k and req.top_k < len(z):
                kth = np.partition(z, -req.top_k)[-req.top_k]
                z = np.where(z < kth, -np.inf, z)
            z = z - z.max()
            p = np.exp(z) / np.exp(z).sum()
            if req.top_p < 1.0:
                # nucleus: the smallest prefix of sorted probabilities
                # whose mass reaches top_p (always >= 1 token)
                order = np.argsort(-p)
                csum = np.cumsum(p[order])
                cut = int(np.searchsorted(csum, req.top_p)) + 1
                keep = np.zeros_like(p, dtype=bool)
                keep[order[:cut]] = True
                p = np.where(keep, p, 0.0)
                p /= p.sum()
            return int(self._rng.choice(len(p), p=p))
        return int(arr.argmax())

    def _emit(self, req: GenerationRequest, logits) -> bool:
        arr = logits.float().cpu().numpy().reshape(-1)
        return self._emit_token(req, self._sample_host(req, arr))

    @torch.no_grad()
    def _step_eager(self) -> None:
        """One token for every active sequence through the Python layer
        walk (``engine.py:1210-1275``); attention reads the pages through
        ``paged_attention_decode``, SSM layers run ``ssm_layer_step``."""
        active = [s for s in sorted(self._slot_req)
                  if not self._slot_req[s].paused]
        if not active:
            return
        cfg, cache, dev = self.cfg, self.cache, self.device
        lens = [int(cache.seq_lens[s]) for s in active]
        ids = torch.tensor([[self._slot_req[s].output_ids[-1]]
                            for s in active], dtype=torch.long, device=dev)
        positions = torch.tensor(lens, device=dev)[:, None]
        # write slots of each sequence's new token
        wslots = torch.from_numpy(np.concatenate(
            [cache.slot_mapping(s, l, 1) for s, l in zip(active, lens)])
            ).to(dev)
        tables = cache.tables_array(active)
        new_lens = torch.tensor([l + 1 for l in lens], dtype=torch.int32,
                                device=dev)
        sl = torch.tensor(active, dtype=torch.long, device=dev)
        attend = (paged_attention_decode if self.use_kernel
                  else _paged.paged_decode_attention_plain)

        model = self.model.llama
        h = model.embed_tokens(ids)
        kv_li = 0
        for li, layer in enumerate(model.layers):
            if self._sstate is not None and self._sstate[li] is not None:
                st = self._sstate[li]
                # the compiled step's own recurrence, on the same weights
                h2, conv_new, ssm_new = _ds.ssm_layer_step(
                    h[:, 0, :], _ds.ssm_params(layer), self._ssm_specs[li],
                    st["conv"][sl], st["ssm"][sl], cfg.rms_norm_eps)
                st["conv"].index_copy_(0, sl, conv_new.to(st["conv"].dtype))
                st["ssm"].index_copy_(0, sl, ssm_new)
                h = h2[:, None, :]
                continue
            q, k, v = self._layer_kv(layer, h)
            qr, kr = self._rope(q, k, positions)
            cache.write(kv_li, kr[:, 0], v[:, 0], wslots)
            kc, vc, _, _ = cache.layer(kv_li)    # eager pages are full width
            out = attend(qr[:, 0], kc, vc, tables, new_lens,
                         cache.block_size)
            kv_li += 1
            h = self._finish_layer(layer, h, out[:, None])
        logits = self.model.logits(model.norm(h)[:, 0])
        rows = logits.float().cpu().numpy()         # the step's host sync
        survivors = []
        for i, s in enumerate(active):
            cache.seq_lens[s] = lens[i] + 1
            req = self._slot_req[s]
            if not self._emit_token(req, self._sample_host(req, rows[i])):
                survivors.append(req)
        for req in survivors:
            self._reserve_next(req)

    # -- the compiled step ----------------------------------------------
    def _plan_step(self):
        """This step's packed work: every decoding sequence contributes its
        pending token, then the remaining token budget goes to prompt
        chunks in slot order. Entries are ``(req, start, chunk, n_out)``
        with ``n_out`` the number of trailing positions that sample (0 for
        a prompt chunk that does not finish the prompt)."""
        cache = self.cache
        entries = []
        budget = self.max_tokens_per_step
        for s in sorted(self._slot_req):
            req = self._slot_req[s]
            if req.paused:          # backpressured: holds pages, no work
                continue
            if req._prompt_pos >= len(req.input_ids) and budget > 0:
                start = int(cache.seq_lens[s])
                if not cache.ensure_capacity(s, start + 1):
                    self._finish(req, "cache_exhausted")
                    continue
                entries.append((req, start, [req.output_ids[-1]], 1))
                budget -= 1
        for s in sorted(self._slot_req):
            req = self._slot_req[s]
            if req.paused:
                continue
            prompt_len = len(req.input_ids)
            if req._prompt_pos < prompt_len and budget > 0:
                n = min(self.prefill_chunk, prompt_len - req._prompt_pos,
                        budget)
                start = req._prompt_pos
                chunk = req.input_ids[start:start + n]
                entries.append((req, start, chunk,
                                1 if start + n == prompt_len else 0))
                budget -= n
        return entries

    def _upload(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One host-to-device copy for a dict of same-dtype arrays."""
        flat = np.concatenate([a.reshape(-1) for a in arrays.values()])
        dev = torch.from_numpy(flat).to(self.device)
        out, off = {}, 0
        for name, a in arrays.items():
            out[name] = dev[off:off + a.size].view(a.shape)
            off += a.size
        return out

    def _step_compiled(self) -> None:
        cache = self.cache
        entries = self._plan_step()
        if not entries:
            return
        ids, positions, rows, wslots, valids, out_rows = [], [], [], [], [], []
        sslots = []             # per-token SSM state slots (hybrids)
        n_prefill = 0
        v_b = _ds.bucket(max(max(e[3] for e in entries), 1))
        for row, (req, start, chunk, n_out) in enumerate(entries):
            n = len(chunk)
            base = len(ids)
            ids.extend(chunk)
            positions.extend(range(start, start + n))
            rows.extend([row] * n)
            wslots.extend(cache.slot_mapping(req.slot, start, n).tolist())
            sslots.extend([req.slot] * n)
            valids.extend(range(start + 1, start + n + 1))
            m = max(n_out, 1)
            first = base + n - m
            out_rows.append([first + i for i in range(m)]
                            + [base + n - 1] * (v_b - m))
            if req._prompt_pos < len(req.input_ids):
                n_prefill += n

        t_b = _ds.bucket(len(ids), self._tok_floor)
        s_b = _ds.bucket(len(entries))
        w_b = min(_ds.bucket(max(len(cache._tables[e[0].slot])
                                 for e in entries)), cache._bps)
        pad_t = t_b - len(ids)
        ints = {
            "ids": np.asarray(ids + [0] * pad_t, np.int32),
            "positions": np.asarray(positions + [0] * pad_t, np.int32),
            "rows": np.asarray(rows + [0] * pad_t, np.int32),
            "wslots": np.asarray(wslots + [cache.sentinel] * pad_t, np.int32),
            # pad tokens update the state's spare row past max_seqs
            "sslots": np.asarray(sslots + [self.max_seqs] * pad_t, np.int32),
            "valids": np.asarray(valids + [0] * pad_t, np.int32),
            "row_slots": np.zeros((s_b,), np.int32),
            "out_idx": np.zeros((s_b, v_b), np.int32),
            "draft_next": np.zeros((s_b, max(v_b - 1, 0)), np.int32),
            "n_spec": np.zeros((s_b,), np.int32),
            "seeds": np.zeros((s_b,), np.int32),
            "counters": np.zeros((s_b,), np.int32),
            "top_ks": np.zeros((s_b,), np.int32),
        }
        floats = {"temps": np.zeros((s_b,), np.float32),
                  "top_ps": np.ones((s_b,), np.float32)}
        for row, (req, start, chunk, n_out) in enumerate(entries):
            ints["row_slots"][row] = req.slot
            ints["out_idx"][row] = out_rows[row]
            ints["seeds"][row] = req.seed or 0
            ints["counters"][row] = len(req.output_ids)
            ints["top_ks"][row] = req.top_k
            floats["temps"][row] = req.temperature or 0.0
            floats["top_ps"][row] = req.top_p
        a = self._upload(ints)
        f = self._upload(floats)
        tokens, accepted = self._dstep(
            int(w_b), self._params, cache, self._sstate, a["ids"],
            a["positions"], a["rows"], a["wslots"], a["sslots"],
            cache.tables_device(),
            a["row_slots"], a["valids"], a["out_idx"], a["draft_next"],
            a["n_spec"], a["seeds"], a["counters"], f["temps"], a["top_ks"],
            f["top_ps"])
        toks = tokens.cpu().numpy()            # the step's one host sync
        self.stats["prefill_tokens"] += n_prefill

        survivors = []
        for row, (req, start, chunk, n_out) in enumerate(entries):
            n = len(chunk)
            cache.seq_lens[req.slot] = start + n
            if req._prompt_pos < len(req.input_ids):      # prompt chunk
                req._prompt_pos = start + n
                if n_out and not self._emit_token(req, int(toks[row, 0])):
                    survivors.append(req)
                continue
            self.stats["decode_rows"] += 1
            if not self._emit_token(req, int(toks[row, 0])):
                survivors.append(req)
        # reserve next-token capacity only after every finish above has
        # returned its pages
        for req in survivors:
            self._reserve_next(req)

    def step(self) -> None:
        """One continuous-batching step: decoding sequences advance one
        token, prefilling sequences one prompt chunk (compiled mode), in
        one batched forward; paused sequences wait."""
        if not any(not r.paused for r in self._slot_req.values()):
            return          # idle or fully backpressured: no device call
        t0 = time.perf_counter()
        occupancy = len(self._slot_req) / max(1, self.max_seqs)
        if self.mode == "compiled":
            self._step_compiled()
        else:
            self._step_eager()
        self.stats["steps"] += 1
        self.stats["step_time_s"] += time.perf_counter() - t0
        self.stats["occupancy_sum"] += occupancy

    def generate(self, requests: List[GenerationRequest],
                 max_steps: int = 10_000, return_details: bool = False):
        """Run requests to completion with continuous batching.

        Returns ``{request_id: output_ids}``, or with ``return_details``
        ``{request_id: {"output_ids", "finish_reason", "error"}}``.
        Requests that can never fit finish at once as ``"rejected"``."""
        queue = []
        for r in requests:
            if self._admissible(r):
                queue.append(r)
            else:
                self._reject(
                    r, f"prompt of {len(r.input_ids)} tokens can never be "
                    f"admitted (max_seq_len={self.max_seq_len}, pool="
                    f"{self.cache.num_blocks} blocks of "
                    f"{self.cache.block_size})")
        while queue and self.add_request(queue[0]):
            queue.pop(0)
        for _ in range(max_steps):
            if not self._slot_req and not queue:
                break
            self.step()
            while queue and self.add_request(queue[0]):
                queue.pop(0)
            self._reaped.clear()    # generate() owns the loop; no reaper
        if return_details:
            return {r.request_id: {"output_ids": r.output_ids,
                                   "finish_reason": r.finish_reason,
                                   "error": r.error}
                    for r in requests}
        return {r.request_id: r.output_ids for r in requests}
