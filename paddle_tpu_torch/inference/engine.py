"""Generation engine: continuous batching over a paged KV cache (port of
``paddle_tpu/inference/engine.py``, the compiled mode).

Host side: the request queue, slot and block allocation, chunked-prefill
scheduling and finish bookkeeping. Device side: one call of the decode
step (:mod:`paddle_tpu_torch.inference.decode_step`) per engine step over
packed ragged tokens — each decoding sequence contributes its pending
token, the remaining token budget goes to prompt chunks — padded to
power-of-two buckets (token count, row count, output count, table width)
as in the reference, so a step's shapes depend only on its bucket.

Per step the host uploads the packed int32 and float32 inputs in one copy
each and reads the sampled tokens back in one sync.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): ``mode="eager"``, speculative decode (``spec_tokens > 0``), the
prefix cache, quantized KV pages, weight-only int8, the host KV tier,
and non-Llama, MoE or hybrid models.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.framework.dtype import to_torch_dtype
from paddle_tpu_torch.inference import decode_step as _ds
from paddle_tpu_torch.inference.paged_cache import PagedKVCache

__all__ = ["GenerationEngine", "GenerationRequest"]


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
        # "eos" | "length" | "cache_exhausted" | "rejected" | None
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self._prompt_pos = 0           # prompt tokens written


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
        if mode == "eager":
            raise _unported("mode='eager'", "A.6")
        if mode not in ("auto", "compiled"):
            raise ValueError(f"mode must be 'auto', 'compiled' or 'eager', "
                             f"got {mode!r}")
        reason = _ds.compiled_capable(model)
        if reason is not None:
            raise NotImplementedError(
                f"GenerationEngine: {reason}; only dense Llama models are "
                f"ported (ROADMAP.md A.8/A.9)")
        for name, value, default, item in (
                ("spec_tokens", spec_tokens, "serve_spec_tokens", "A.6"),
                ("prefix_cache", prefix_cache, "serve_prefix_cache", "A.6"),
                ("kv_quant", kv_quant, "serve_kv_quant", "A.7"),
                ("weight_quant", weight_quant, "serve_weight_quant", "A.7"),
                ("host_tier", host_tier, "serve_kv_host_tier", "A.7")):
            if value is None:
                value = flags.flag(default)
            if value not in (None, False, 0, "off", "none"):
                raise _unported(f"{name}={value!r}", item)
        self.model = model
        cfg = model.config
        self.cfg = cfg
        self.mode = "compiled"
        self.device = model.device
        blocks_per_seq = -(-max_seq_len // block_size)
        num_blocks = num_blocks or max_seqs * blocks_per_seq
        self.max_seq_len = max_seq_len
        self.cache = PagedKVCache(
            cfg.num_hidden_layers, num_blocks, block_size,
            cfg.num_key_value_heads, cfg.head_dim, max_seqs,
            dtype=to_torch_dtype(cfg.dtype),
            blocks_per_seq=_ds.bucket(blocks_per_seq), device=self.device)
        self._requests: Dict[object, GenerationRequest] = {}
        self._slot_req: Dict[int, GenerationRequest] = {}
        self.max_seqs = max_seqs
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_tokens_per_step = int(max_tokens_per_step
                                       or max_seqs + self.prefill_chunk)
        self._tok_floor = max(1, int(token_bucket_floor))
        self._seed_counter = 0
        self.stats = {"steps": 0, "step_time_s": 0.0, "decode_tokens": 0,
                      "prefill_tokens": 0, "occupancy_sum": 0.0,
                      "decode_rows": 0}
        self._params = _ds.extract_params(model)
        self._dstep = _ds.make_step(cfg, block_size, use_kernel=use_kernel)

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
        return True

    def _finish(self, req: GenerationRequest, reason: str) -> None:
        req.finished = True
        if req.finish_reason is None:
            req.finish_reason = reason
        self.cache.free_slot(req.slot)
        del self._slot_req[req.slot]
        self._requests.pop(req.request_id, None)

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

    # -- the step -------------------------------------------------------
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
            if req._prompt_pos >= len(req.input_ids) and budget > 0:
                start = int(cache.seq_lens[s])
                if not cache.ensure_capacity(s, start + 1):
                    self._finish(req, "cache_exhausted")
                    continue
                entries.append((req, start, [req.output_ids[-1]], 1))
                budget -= 1
        for s in sorted(self._slot_req):
            req = self._slot_req[s]
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
        n_prefill = 0
        v_b = _ds.bucket(max(max(e[3] for e in entries), 1))
        for row, (req, start, chunk, n_out) in enumerate(entries):
            n = len(chunk)
            base = len(ids)
            ids.extend(chunk)
            positions.extend(range(start, start + n))
            rows.extend([row] * n)
            wslots.extend(cache.slot_mapping(req.slot, start, n).tolist())
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
            int(w_b), self._params, cache, a["ids"], a["positions"],
            a["rows"], a["wslots"], cache.tables_device(), a["row_slots"],
            a["valids"], a["out_idx"], a["draft_next"], a["n_spec"],
            a["seeds"], a["counters"], f["temps"], a["top_ks"], f["top_ps"])
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
        token, prefilling sequences one prompt chunk, in one batched
        forward."""
        if not self._slot_req:
            return
        t0 = time.perf_counter()
        occupancy = len(self._slot_req) / max(1, self.max_seqs)
        self._step_compiled()
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
        if return_details:
            return {r.request_id: {"output_ids": r.output_ids,
                                   "finish_reason": r.finish_reason,
                                   "error": r.error}
                    for r in requests}
        return {r.request_id: r.output_ids for r in requests}
