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
  each and reads the sampled tokens back in one sync. The step runs as a
  ``jit.to_static`` program per bucket signature, as the reference runs
  one compiled executable per trace (``engine.py:313-327``): on CUDA a
  signature's first call runs eagerly, its second captures the step into
  a CUDA graph, and every later call copies the two packed inputs into the
  program's static buffers and replays the graph. The weights, the pages,
  the block table and the SSM state are read in place, never copied;
  :meth:`~GenerationEngine.decode_signatures` counts the signatures met.
  Under ``jit.enable_to_static(False)`` the step runs op by op.
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

Speculative decode, the prefix cache and the host-RAM KV tier, as in the
reference (``engine.py:31-44``): with ``spec_tokens > 0`` the compiled step
carries, for each decoding sequence, up to ``spec_tokens`` draft tokens
proposed by prompt lookup (the context's trailing n-gram matched against
the request's own prompt and output; no second model), verified as one
chunk; the accepted run is emitted in the same step (it comes back in the
step's one host read, beside the tokens) and the KV cursor rewinds over the
rejected tail, so greedy and seeded streams equal non-speculative decode.
``prefix_cache`` links a new prompt onto pages an earlier request wrote
(:meth:`~paddle_tpu_torch.inference.paged_cache.PagedKVCache.adopt_prefix`)
and prefill resumes past the linked run. ``host_tier`` (with
``host_tier_bytes`` and ``restore_ahead``) spills cold prefix pages and
paused requests' pages to host RAM instead of evicting them;
:meth:`~GenerationEngine.spill_paused` parks, and the step's restore pass
stages a resumed slot's pages one step ahead (or restores them inline with
``restore_ahead`` off). All three are features of the compiled step: in
eager mode ``spec_tokens`` is kept and unused and the prefix cache is
never consulted, as in the reference, and the tier is turned off with a
warning; a hybrid model turns all three off with the reference's warnings.
"""

from __future__ import annotations

import math
import time
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch import flags
from paddle_tpu_torch.framework.dtype import to_torch_dtype
from paddle_tpu_torch.incubate.nn import functional as F_inc
from paddle_tpu_torch.incubate.nn.functional.fused_ops import rope_tables
from paddle_tpu_torch.inference import decode_step as _ds
from paddle_tpu_torch.inference.attention import paged_attention_decode
from paddle_tpu_torch.inference.paged_cache import PagedKVCache
from paddle_tpu_torch.jit import api as _jit
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


def _layouts(t_b: int, s_b: int, v_b: int):
    """The compiled step's packed inputs at a bucket signature: ``(name,
    shape)`` of each int32 field, then of each fp32 one, in packing
    order."""
    t, s = (t_b,), (s_b,)
    ints = (("ids", t), ("positions", t), ("rows", t), ("wslots", t),
            ("sslots", t), ("valids", t), ("row_slots", s),
            ("out_idx", (s_b, v_b)), ("draft_next", (s_b, max(v_b - 1, 0))),
            ("n_spec", s), ("seeds", s), ("counters", s), ("top_ks", s))
    return ints, (("temps", s), ("top_ps", s))


def _step_of(engine):
    """The engine's ``to_static`` function: its step over the packed
    inputs, with its state registered for the program's storage guard and
    their identity as a host guard. It and the guards reach the engine
    through a weak reference, so that its programs (their graphs and the
    graph pool) go with the engine when it is dropped rather than at the
    next collection of a reference cycle."""
    ref = weakref.ref(engine)

    def state():
        return ref()._step_state()

    def state_ids():
        return ref()._state_ids()

    def decode_step(width, t_b, s_b, v_b, ints, floats):
        _jit.note_state(state)
        _jit.host_guard(state_ids)
        return ref()._graph_step(width, t_b, s_b, v_b, ints, floats)
    return decode_step


def _unpack(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Views of a packed buffer, one a field of ``layout``."""
    out, off = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


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
        # the prompt-lookup proposer's state: {ngram -> end index of its
        # latest occurrence} over prompt + output, 3-grams then 2-grams,
        # built incrementally
        self._ngram_idx: Tuple[dict, dict] = ({}, {})
        self._ngram_pos = 0


class GenerationEngine:
    def __init__(self, model, max_seqs=8, max_seq_len=2048, block_size=64,
                 num_blocks=None, mode="auto", prefill_chunk=64,
                 max_tokens_per_step=None, token_bucket_floor=8,
                 spec_tokens=None, prefix_cache=None, kv_quant=None,
                 weight_quant=None, host_tier=None, host_tier_bytes=None,
                 restore_ahead=None, use_kernel=True):
        if mode not in ("auto", "compiled", "eager"):
            raise ValueError(f"mode must be 'auto', 'compiled' or 'eager', "
                             f"got {mode!r}")
        llama = getattr(model, "llama", None)
        if llama is None or not hasattr(llama, "layers"):
            raise NotImplementedError(
                "GenerationEngine: model has no llama-style decoder stack "
                "(model.llama); the port serves Llama stacks (dense or MoE) "
                "and hybrid SSM models; other model families are ROADMAP.md "
                "A.13")
        reason = _ds.compiled_capable(model)
        if mode == "auto":
            mode = "compiled" if reason is None else "eager"
            if reason is not None:
                _warn_fallback("compiled decode", reason)
        elif mode == "compiled" and reason is not None:
            raise NotImplementedError(
                f"GenerationEngine(mode='compiled'): {reason}; mode='eager' "
                f"or 'auto' serves it through the layer walk")
        if spec_tokens is None:
            spec_tokens = flags.flag("serve_spec_tokens")
        self.spec_tokens = max(0, int(spec_tokens))
        if prefix_cache is None:
            prefix_cache = flags.flag("serve_prefix_cache")
        self._prefix_on = bool(prefix_cache)
        if host_tier is None:
            host_tier = flags.flag("serve_kv_host_tier")
        self._tier_on = bool(host_tier)
        if host_tier_bytes is None:
            host_tier_bytes = flags.flag("serve_kv_host_bytes")
        self._host_tier_bytes = int(host_tier_bytes)
        if restore_ahead is None:
            restore_ahead = flags.flag("serve_kv_restore_ahead")
        self._restore_ahead = bool(restore_ahead)
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
            if self.spec_tokens > 0:
                _warn_once(
                    "speculative decode",
                    "SSM recurrent state cannot roll back rejected drafts; "
                    "forcing spec_tokens=0 for hybrid models")
                self.spec_tokens = 0
            if self._prefix_on:
                _warn_once(
                    "prefix cache",
                    "linked KV pages carry no SSM recurrent state, so a "
                    "prefix hit would skip the scan that builds it; "
                    "disabling for hybrid models")
                self._prefix_on = False
            if self.kv_quant is not None:
                _warn_once(
                    "kv quant",
                    "hybrid-SSM steps carry recurrent state beside the KV "
                    "pools and their scan state is full-width; disabling "
                    "quantized KV pages for hybrid models")
                self.kv_quant = None
            if self._tier_on:
                _warn_once(
                    "kv host tier",
                    "parked KV pages carry no SSM recurrent state and "
                    "hybrid prefix caching is already off; disabling the "
                    "host tier for hybrid models")
                self._tier_on = False
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
            if self._tier_on:
                _warn_once(
                    "kv host tier",
                    "spill/restore is a compiled-step feature (the eager "
                    "walk is the parity oracle and stays single-tier); "
                    "disabling in eager mode")
                self._tier_on = False
        dtype = to_torch_dtype(cfg.dtype)
        self.cache = PagedKVCache(
            n_kv_layers, num_blocks, block_size,
            cfg.num_key_value_heads, cfg.head_dim, max_seqs, dtype=dtype,
            blocks_per_seq=_ds.bucket(blocks_per_seq), device=self.device,
            quant=self.kv_quant,
            host_tier_bytes=self._host_tier_bytes if self._tier_on else None)
        # staged restores: slot -> the planes whose host-to-device copy was
        # issued last step, completed before planning
        self._pending_restore: Dict[int, object] = {}
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
        self.max_tokens_per_step = int(
            max_tokens_per_step
            or max_seqs * (1 + self.spec_tokens) + self.prefill_chunk)
        self._tok_floor = max(1, int(token_bucket_floor))
        self._seed_counter = 0
        self._reaped: List[GenerationRequest] = []
        self.stats = {"steps": 0, "step_time_s": 0.0, "decode_tokens": 0,
                      "prefill_tokens": 0, "occupancy_sum": 0.0,
                      # speculative decode
                      "decode_rows": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "spec_rollbacks": 0,
                      # prefix cache, counted in tokens
                      "prefix_lookup_tokens": 0, "prefix_hit_tokens": 0}
        # bucket signatures (width, tokens, rows, outputs) the step has met
        self._signatures: set = set()
        if mode == "compiled":
            self._params = _ds.extract_params(
                model, weight_quant=self.weight_quant)
            self._param_leaves = [t for t in pytree.tree_leaves(self._params)
                                  if isinstance(t, torch.Tensor)]
            self._dstep = _ds.make_step(cfg, block_size,
                                        use_kernel=use_kernel,
                                        moe=_ds.extract_moe_specs(model),
                                        ssm=self._ssm_specs,
                                        kv_quant=self.kv_quant)
            # one to_static program per signature, all capturing into one
            # graph pool. Sharing it is safe: this engine's replays never
            # overlap (its steps run one after another, each under
            # device_work, and a capture waits for every other device
            # user), and a replay's one output is cloned, then read on the
            # host, before the next replay can write a temporary over it.
            # A pool per program would hold a step's peak temporaries (the
            # LM head's fp32 cast alone is 2.1 GB at Llama-3-8B widths)
            # for each of the tens of signatures a serving run meets
            self._program = _jit.StaticFunction(
                _step_of(self), name="decode_step", shared_pool=True)

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
        with _jit.device_work():
            return self._add_request(request)

    def _add_request(self, request: GenerationRequest) -> bool:
        slot = self.cache.allocate_slot()
        if slot is None:
            return False
        matched = 0
        if self._prefix_on and self.mode == "compiled":
            n = len(request.input_ids)
            matched = self.cache.adopt_prefix(slot, request.input_ids)
            self.stats["prefix_lookup_tokens"] += n
            self.stats["prefix_hit_tokens"] += min(matched, n - 1)
            # re-validate the admission estimate against what the link
            # covered: peeked entries hold no reference and may have been
            # evicted since; capped at the pool, so an over-long request
            # still runs alone rather than wedging the queue
            total = min(n + int(request.max_new_tokens), self.max_seq_len)
            need = (min(-(-total // self.cache.block_size),
                        self.cache.num_blocks)
                    - len(self.cache._tables[slot]))
            if self.cache.available_blocks < need:
                self.cache.free_slot(slot)  # unlinks the adopted pages
                return False
        if not self.cache.ensure_capacity(slot, len(request.input_ids)):
            self.cache.free_slot(slot)      # also unlinks adopted pages
            return False
        request.slot = slot
        if request.seed is None:
            request.seed = self._seed_counter
            self._seed_counter += 1
        self._requests[request.request_id] = request
        self._slot_req[slot] = request
        # resume prefill past the linked prefix; the last prompt token
        # always runs again, so that there are logits to sample from
        resume = min(matched, len(request.input_ids) - 1)
        request._prompt_pos = resume
        self.cache.seq_lens[slot] = resume
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
        if self._prefix_on and self.mode == "compiled":
            # index the full blocks of prompt + output before the pages go
            # back: the next request with this prefix links them
            toks = req.input_ids + req.output_ids
            valid = min(int(self.cache.seq_lens[req.slot]), len(toks))
            self.cache.register_prefix(req.slot, toks, valid)
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
        with _jit.device_work():
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
        requested output, capped at the serving max length. With the prefix
        cache on, blocks the cache can link are not new allocations: the
        estimate peeks the index's resident run (a spilled hit still needs
        blocks to restore into), keeping one block for the possible
        copy-on-write. The peek takes no reference; :meth:`add_request`
        re-validates against what the link covered."""
        total = min(len(req.input_ids) + int(req.max_new_tokens),
                    self.max_seq_len)
        blocks = -(-total // self.cache.block_size)
        if self._prefix_on and self.mode == "compiled":
            cached = (self.cache.peek_prefix_resident(req.input_ids)
                      // self.cache.block_size)
            blocks = max(1, blocks - max(0, cached - 1))
        return blocks

    def spillable_blocks(self) -> int:
        """Device blocks a spill pass could free right now: paused
        requests' parkable page runs, capped by the host tier's room (0
        without a tier). The server's admission adds these to
        ``available_blocks``."""
        cache = self.cache
        if cache.host_tier is None:
            return 0
        total = sum(cache.spillable_suffix(slot)
                    for slot, req in self._slot_req.items()
                    if req.paused and slot not in self._pending_restore)
        return min(total, cache.host_tier.available_blocks)

    def spill_paused(self, max_blocks: Optional[int] = None) -> int:
        """Park paused requests' pages in the host tier (pinned), freeing
        device blocks for admission; the server calls this under pressure.
        Returns the blocks freed."""
        cache = self.cache
        if cache.host_tier is None:
            return 0
        freed = 0
        with _jit.device_work():
            for slot in sorted(self._slot_req):
                if max_blocks is not None and freed >= max_blocks:
                    break
                req = self._slot_req[slot]
                if not req.paused or slot in self._pending_restore:
                    continue
                freed += cache.spill_slot(slot)
        return freed

    def release_prefix_cache(self) -> int:
        """Drop the prefix index and its page holds, both tiers (leak
        drills call this before asserting ``free_blocks == num_blocks``).
        Returns the entries dropped."""
        return self.cache.clear_prefix()

    def export_request(self, request_id):
        """Handoff, sending side: the request's KV pages, generation state
        and refcounts as one record (:func:`~paddle_tpu_torch.inference.
        kv_handoff.export_handoff`); None for an unknown or mid-prefill
        request. The caller evicts with reason ``"handoff"`` after it."""
        from paddle_tpu_torch.inference import kv_handoff
        with _jit.device_work():
            return kv_handoff.export_handoff(self, request_id)

    def import_request(self, record, request=None):
        """Handoff, receiving side: install a record as an already
        prefilled request (:func:`~paddle_tpu_torch.inference.kv_handoff.
        install_handoff`); None when no slot or blocks are free."""
        from paddle_tpu_torch.inference import kv_handoff
        with _jit.device_work():
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

    # -- speculative drafts ----------------------------------------------
    def _propose_drafts(self, req: GenerationRequest, k: int) -> List[int]:
        """Prompt-lookup draft proposal (``engine.py:752-789``): match the
        context's trailing 3-gram (then 2-gram) against an incrementally
        built index of the request's own prompt and output and return the
        continuation after its latest occurrence, extended periodically
        when the match sits fewer than ``k`` tokens from the end (the
        context is cycling with that period)."""
        if k <= 0:
            return []
        ctx = req.input_ids + req.output_ids
        n = len(ctx)
        if n < 2:
            return []
        idx3, idx2 = req._ngram_idx
        # index the n-grams ending strictly before the query position n-1
        for e in range(req._ngram_pos, n - 1):
            if e >= 1:
                idx2[(ctx[e - 1], ctx[e])] = e
            if e >= 2:
                idx3[(ctx[e - 2], ctx[e - 1], ctx[e])] = e
        req._ngram_pos = n - 1
        p = None
        if n >= 3:
            p = idx3.get((ctx[n - 3], ctx[n - 2], ctx[n - 1]))
        if p is None:
            p = idx2.get((ctx[n - 2], ctx[n - 1]))
        if p is None:
            return []
        period = (n - 1) - p
        return [ctx[p + 1 + (i % period)] for i in range(k)]

    # -- the compiled step ----------------------------------------------
    def _restore_pass(self) -> None:
        """The host tier's restores, before planning (``engine.py:790-824``):
        complete the restores staged last step (their copies ran beside
        that step), then stage the next round — every resumed slot still
        parked — or, with ``restore_ahead`` off, restore it inline so that
        it decodes this step."""
        cache = self.cache
        if cache.host_tier is None:
            return
        for slot, staged in list(self._pending_restore.items()):
            if slot not in self._slot_req or cache.slot_spilled(slot) == 0:
                del self._pending_restore[slot]     # finished or evicted
                continue
            if cache.restore_slot(slot, staged=staged):
                del self._pending_restore[slot]
            # else the pool is still too tight: keep the staged planes
        for slot in sorted(self._slot_req):
            req = self._slot_req[slot]
            if (req.paused or slot in self._pending_restore
                    or cache.slot_spilled(slot) == 0):
                continue
            if self._restore_ahead:
                staged = cache.stage_restore(slot)
                if staged is not None:
                    self._pending_restore[slot] = staged
            else:
                cache.restore_slot(slot)

    def _plan_step(self):
        """This step's packed work: every decoding sequence contributes its
        pending token and up to ``spec_tokens`` drafts (a verify chunk),
        then the remaining token budget goes to prompt chunks in slot
        order. Entries are ``(req, start, chunk, n_out, n_spec)``: ``n_out``
        the number of trailing positions that sample (0 for a prompt chunk
        that does not finish the prompt), ``n_spec`` the number of the
        chunk's tokens that are unverified drafts."""
        cache = self.cache
        entries = []
        budget = self.max_tokens_per_step
        spec_k = self.spec_tokens
        for s in sorted(self._slot_req):
            req = self._slot_req[s]
            if req.paused:          # backpressured: holds pages, no work
                continue
            if cache.slot_spilled(s):   # restore in flight: next step
                continue
            if req._prompt_pos >= len(req.input_ids):      # decoding
                if budget <= 0:
                    continue
                start = int(cache.seq_lens[s])
                drafts: List[int] = []
                if spec_k > 0:
                    k = min(spec_k,
                            req.max_new_tokens - len(req.output_ids) - 1,
                            budget - 1, self.max_seq_len - start - 1)
                    if k > 0:
                        drafts = self._propose_drafts(req, k)
                if not cache.ensure_capacity(s, start + 1 + len(drafts)):
                    # the pool is too tight for the draft run: retry bare
                    drafts = []
                    if not cache.ensure_capacity(s, start + 1):
                        self._finish(req, "cache_exhausted")
                        continue
                chunk = [req.output_ids[-1]] + drafts
                entries.append((req, start, chunk, len(chunk), len(drafts)))
                budget -= len(chunk)
        for s in sorted(self._slot_req):
            req = self._slot_req[s]
            if req.paused or cache.slot_spilled(s):
                continue
            prompt_len = len(req.input_ids)
            if req._prompt_pos < prompt_len and budget > 0:
                n = min(self.prefill_chunk, prompt_len - req._prompt_pos,
                        budget)
                start = req._prompt_pos
                chunk = req.input_ids[start:start + n]
                entries.append((req, start, chunk,
                                1 if start + n == prompt_len else 0, 0))
                budget -= n
        return entries

    def _upload(self, arrays: Dict[str, np.ndarray]) -> torch.Tensor:
        """One host-to-device copy for a dict of same-dtype arrays, packed
        in order (the step takes views, :func:`_unpack`)."""
        flat = np.concatenate([a.reshape(-1) for a in arrays.values()])
        return torch.from_numpy(flat).to(self.device)

    def _step_state(self) -> List[torch.Tensor]:
        """Every tensor the step reads or writes besides its packed
        inputs: the weights, the pages (and scales), the block table and
        the SSM state. They are read in place; a program guards their
        storage, so ``load_jax_state``'s in-place copy keeps the programs
        and a tensor replaced under the engine makes a new one."""
        cache = self.cache
        state = self._param_leaves + cache._planes() + [cache._tables_dev]
        for st in self._sstate or ():
            if st is not None:
                state += [st["conv"], st["ssm"]]
        return state

    def _state_ids(self) -> Tuple[int, ...]:
        """The host guard beside the storage guard: the identity of the
        state past the weights (pages, table, SSM state), which a
        replaced tensor changes where the old one's storage stays put."""
        return tuple(map(id, self._step_state()[len(self._param_leaves):]))

    def _graph_step(self, width, t_b, s_b, v_b, ints, floats):
        """The decode step over the packed inputs of one bucket signature
        (what the engine's ``to_static`` function runs): the tokens
        ``[s_b, v_b]`` with the accepted-draft counts as one more
        column."""
        ilay, flay = _layouts(t_b, s_b, v_b)
        a, f = _unpack(ints, ilay), _unpack(floats, flay)
        cache = self.cache
        tokens, accepted = self._dstep(
            width, self._params, cache, self._sstate, a["ids"],
            a["positions"], a["rows"], a["wslots"], a["sslots"],
            cache.tables_device(), a["row_slots"], a["valids"], a["out_idx"],
            a["draft_next"], a["n_spec"], a["seeds"], a["counters"],
            f["temps"], a["top_ks"], f["top_ps"])
        return torch.cat([tokens, accepted[:, None]], dim=1)

    def _step_compiled(self) -> None:
        cache = self.cache
        self._restore_pass()
        entries = self._plan_step()
        if not entries:
            return
        ids, positions, rows, wslots, valids, out_rows = [], [], [], [], [], []
        sslots = []             # per-token SSM state slots (hybrids)
        n_prefill = 0
        v_b = _ds.bucket(max(max(e[3] for e in entries), 1))
        for row, (req, start, chunk, n_out, _) in enumerate(entries):
            n = len(chunk)
            base = len(ids)
            ids.extend(chunk)
            positions.extend(range(start, start + n))
            rows.extend([row] * n)
            wslots.extend(cache.slot_mapping(req.slot, start, n).tolist())
            sslots.extend([req.slot] * n)
            valids.extend(range(start + 1, start + n + 1))
            # output columns: the last max(n_out, 1) chunk positions; pad
            # columns repeat the final index (the host ignores them)
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
        self._signatures.add((int(w_b), t_b, s_b, v_b))
        ilay, flay = _layouts(t_b, s_b, v_b)
        ints = {name: np.zeros(shape, np.int32) for name, shape in ilay}
        floats = {name: np.zeros(shape, np.float32) for name, shape in flay}
        n = len(ids)
        for name, vals in (("ids", ids), ("positions", positions),
                           ("rows", rows), ("wslots", wslots),
                           ("sslots", sslots), ("valids", valids)):
            ints[name][:n] = vals
        ints["wslots"][n:] = cache.sentinel
        # pad tokens update the state's spare row past max_seqs
        ints["sslots"][n:] = self.max_seqs
        floats["top_ps"][:] = 1.0
        for row, (req, start, chunk, n_out, n_spec) in enumerate(entries):
            ints["row_slots"][row] = req.slot
            ints["out_idx"][row] = out_rows[row]
            # draft_next[i]: the draft that output column i must reproduce
            # to extend the accepted run (chunk token i + 1)
            first = len(chunk) - max(n_out, 1)
            ints["draft_next"][row, :n_spec] = chunk[first + 1:
                                                     first + 1 + n_spec]
            ints["n_spec"][row] = n_spec
            ints["seeds"][row] = req.seed or 0
            ints["counters"][row] = len(req.output_ids)
            ints["top_ks"][row] = req.top_k
            floats["temps"][row] = req.temperature or 0.0
            floats["top_ps"][row] = req.top_p
        a, f = self._upload(ints), self._upload(floats)
        cache.tables_device()   # the queued table deltas land outside a graph
        # the step's one host sync: the tokens, with the accepted-draft
        # counts as one more column
        back = self._program(int(w_b), t_b, s_b, v_b, a, f).cpu().numpy()
        toks, acc = back[:, :-1], back[:, -1]
        self.stats["prefill_tokens"] += n_prefill

        survivors = []
        for row, (req, start, chunk, n_out, n_spec) in enumerate(entries):
            n = len(chunk)
            if req._prompt_pos < len(req.input_ids):      # prompt chunk
                cache.seq_lens[req.slot] = start + n
                req._prompt_pos = start + n
                if req._prompt_pos >= len(req.input_ids) and self._prefix_on:
                    cache.register_prefix(req.slot, req.input_ids,
                                          len(req.input_ids))
                if n_out and not self._emit_token(req, int(toks[row, 0])):
                    survivors.append(req)
                continue
            # decode row: emit the accepted draft run and one more token
            acc_n = int(acc[row]) if n_spec else 0
            self.stats["decode_rows"] += 1
            if n_spec:
                self.stats["spec_drafted"] += n_spec
                self.stats["spec_accepted"] += acc_n
                if acc_n < n_spec:
                    self.stats["spec_rollbacks"] += 1
            new_len = start + 1 + acc_n
            cache.seq_lens[req.slot] = new_len
            if acc_n < n_spec:
                # rewind the KV cursor: rows past new_len are stale (masked
                # by valids, overwritten later); whole blocks past the next
                # token's need go back now
                cache.trim_slot(req.slot, new_len + 1)
            finished = False
            for i in range(acc_n + 1):
                if self._emit_token(req, int(toks[row, i])):
                    finished = True
                    break
            if not finished:
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
        with _jit.device_work():
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

    # -- introspection ---------------------------------------------------
    def decode_signatures(self) -> int:
        """Distinct bucket signatures (table width, token, row and output
        buckets) the compiled step has met, one program each (the
        reference's trace count, ``engine.py:1317-1322``); 0 in eager mode.
        The port counts with or without observability, whose registry it
        does not port (ROADMAP.md A.12)."""
        return len(self._signatures)

    def capture_stats(self) -> Dict[str, object]:
        """The compiled step's programs: the signatures met, the programs
        (a replaced state tensor makes a second one for its signature),
        how many replay a CUDA graph, the reasons of any that run eagerly,
        the capture seconds (and their parts: the synchronise and release
        before a capture, the step run under capture, instantiation) and
        the bytes the captures added to the shared graph pool (zero
        captures on the CPU)."""
        progs = (self._program.concrete_programs()
                 if self.mode == "compiled" else [])
        return {"signatures": len(self._signatures),
                "programs": len(progs),
                "captured": sum(p.captured for p in progs),
                "eager": [p.reason for p in progs if p.reason is not None],
                "capture_s": sum(p.capture_s for p in progs),
                "capture_parts": {k: sum(p.capture_parts[k] for p in progs)
                                  for k in ("begin", "record",
                                            "instantiate")},
                "pool_bytes": sum(p.pool_bytes for p in progs)}
