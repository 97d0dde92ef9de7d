"""Prefill→decode KV-page handoff for the disaggregated serving plane (port
of ``paddle_tpu/inference/kv_handoff.py``).

A prefill host runs a request's prompt, then ships the filled KV pages (with
the request's generation state and the pages' refcounts) to a decode host,
which installs them into its own
:class:`~paddle_tpu_torch.inference.paged_cache.PagedKVCache` and decodes on
without a second prefill. One record schema (v3) serves every transport:

* in memory, between hosts of one process (the threaded fleet): the record
  itself, its pages as tensors on the prefill engine's device;
* **serialized** (:func:`pack_handoff` / :func:`unpack_handoff`): ``u64
  header_len | header JSON | k bytes | v bytes | [scales] | [SSM planes]``,
  byte-compatible with the JAX package's in both directions (a record
  packed by either unpacks in the other with its arrays bit for bit); what
  CPU hosts put on the wire, and CUDA hosts with ``use_pallas_kernels``
  unset;
* **device to device** between two CUDA host processes
  (:func:`dma_handoff_enabled`), the port's counterpart of the reference's
  remote DMA: the prefill host's export gathers the record's segments
  straight into a device buffer it exports with CUDA IPC
  (:class:`IPCOutbox`), the wire record
  carries a descriptor of that buffer in place of the page bytes (the
  handle, each segment's offset, shape and dtype, the source's endpoint
  and a generation: a port-only form between port hosts), and the decode
  host maps the buffer once per allocation and pulls each segment with the
  remote-copy kernel #18 (:class:`IPCInbox`,
  :func:`~paddle_tpu_torch.ops.kernels.kv_handoff.pages_copy`) on its
  engine's stream. It confirms the buffer with the source before the pull
  (``/ipc/hold``) and after it (``/ipc/release``, which frees the buffer
  for reuse), so pages whose source did not hold the buffer across the
  pull are never installed: :class:`HandoffRefused`, and the router's
  journal replays the request.

:func:`kv_pages_remote_copy` is the reference's SPMD entry point over a
process group (its kernel and twin are in
:mod:`paddle_tpu_torch.ops.kernels.kv_handoff`).

The handoff moves page ownership: export reads the pages while the prefill
engine still holds them, the caller then evicts the request there (its
pages return to that free list), and :func:`install_handoff` places
contents and refcounts onto freshly allocated blocks. Hybrid engines carry
the slot's SSM state planes in the record.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import math
import struct
import threading
import time
import urllib.request as _urlreq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels import _launch
from paddle_tpu_torch.ops.kernels import kv_handoff as _k18
from paddle_tpu_torch.ops.kernels.kv_handoff import (  # noqa: F401
    kv_pages_remote_copy, kv_pages_remote_copy_plain)

__all__ = ["export_handoff", "install_handoff", "pack_handoff",
           "unpack_handoff", "dma_handoff_enabled", "kv_pages_remote_copy",
           "kv_pages_remote_copy_plain", "HandoffRefused", "IPCOutbox",
           "IPCInbox", "handoff_stats", "HANDOFF_VERSION"]

# v2: optional per-layer SSM recurrent-state planes; v3: optional "trace"
# header key (the serialized tracing context)
HANDOFF_VERSION = 3

_META_KEYS = ("request_id", "prompt", "generated", "max_new_tokens",
              "temperature", "top_k", "top_p", "eos_token_id", "seed",
              "seq_len", "block_refs", "kv_quant", "trace")

_ALIGN = 256            # byte alignment of each segment in an IPC buffer
_GRAIN = 2 << 20        # IPC buffers grow in whole 2 MiB


class HandoffRefused(RuntimeError):
    """A device-to-device install whose source did not confirm its buffer
    across the pull (the source died, or released that generation): the
    pages are not installed and the request must be replayed."""


def _dtype_name(dt: torch.dtype) -> str:
    """numpy's (and ml_dtypes') name of a torch dtype, as the wire header
    spells it: ``bfloat16``, ``float32``, ``int8``, ``float8_e4m3fn``."""
    return str(dt).rsplit(".", 1)[-1]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"kv handoff: unknown dtype {name!r}")
    return dt


def _bytes_of(t: torch.Tensor) -> bytes:
    """A tensor's bytes in row-major order (bf16 and fp8 through a byte
    view, which numpy has no type for)."""
    return t.detach().contiguous().cpu().reshape(-1).view(
        torch.uint8).numpy().tobytes()


# Held by a pull from its first #18 launch until its counters are updated,
# and by a reader that needs launch counts and handoff counters that agree
# (a host's /introspect, read from another thread while a pull is running).
counters_lock = threading.Lock()


def handoff_stats(engine) -> Dict[str, float]:
    """Per-engine handoff counters and seconds: ``exports``/``export_s``
    (the gather, into an IPC buffer on the device route),
    ``pulls``/``pull_s``/``segments`` (device to device, with the two
    confirmations), ``installs``/``install_s`` (the cache writes),
    ``refused``."""
    st = getattr(engine, "_handoff_stats", None)
    if st is None:
        st = engine._handoff_stats = {
            "exports": 0, "export_s": 0.0, "pulls": 0, "pull_s": 0.0, "segments": 0, "installs": 0,
            "install_s": 0.0, "refused": 0}
    return st


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# --------------------------------------------------------------- export
def export_handoff(engine, request_id) -> Optional[Dict[str, Any]]:
    """An active request's filled KV pages and generation state as a
    handoff record: pages ``[layers, seq_len, kv_heads, head_dim]`` gathered
    on the engine's device (no host copy), a quantized pool's scales
    ``[layers, seq_len, kv_heads]`` beside them, a hybrid's per-layer state
    planes in ``record["ssm_state"]``. None for an unknown request or one
    still mid-prefill. The caller evicts with reason ``"handoff"`` after a
    successful export.

    An engine given an :class:`IPCOutbox` (``engine._handoff_outbox``, on a
    host with the device-to-device route) gathers the segments straight
    into a buffer the outbox exports, and the record carries that buffer's
    descriptor (``"ipc"``) in place of the arrays."""
    req = engine._requests.get(request_id)
    if req is None or req._prompt_pos < len(req.input_ids):
        return None
    cache = engine.cache
    slot = req.slot
    n = int(cache.seq_lens[slot])
    if n <= 0:
        return None
    t0 = time.perf_counter()
    blocks_used = -(-n // cache.block_size)
    # a tiered cache's parked slot: the record is the resident head's
    # gather followed by the host tier's pages (raw storage, as the record
    # carries it), with no restore round trip through the device pool
    parked = cache.slot_spill_pages(slot)
    res_n, host = n, None
    if parked is not None:
        start, pages = parked
        res_n = min(n, start * cache.block_size)
        host = cache._stack_pages(pages)
    idx = torch.as_tensor(cache.slot_mapping(slot, 0, res_n).astype(
        np.int64), device=cache.device)

    def gather(i, pool, out=None):
        # one-byte pages go through a byte view (no fp8 index_select)
        src = (pool if cache.quant is None or pool.dtype == torch.float32
               else pool.view(torch.uint8))
        if host is not None:
            tail = host[i][:, :n - res_n]
            tail = (tail if tail.dtype == src.dtype
                    else tail.view(src.dtype)).to(cache.device)
            rows = torch.cat([src.index_select(1, idx), tail], dim=1)
            if out is None:
                return rows.view(pool.dtype)
            return out.view(src.dtype).copy_(rows)
        if out is None:
            return src.index_select(1, idx).view(pool.dtype)
        return torch.index_select(src, 1, idx, out=out.view(src.dtype))

    pools = [("k", cache.k), ("v", cache.v)]
    if cache.quant is not None:
        # scales travel with the pages: the same slot gather
        pools += [("k_scale", cache.k_scale), ("v_scale", cache.v_scale)]
    refs = cache.block_refs(slot)
    if parked is not None:
        refs = refs + [1] * len(parked[1])   # a parked page is private

    record = {
        "version": HANDOFF_VERSION,
        "request_id": req.request_id,
        "prompt": list(req.input_ids),
        "generated": list(req.output_ids),
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": req.temperature,
        "top_k": req.top_k,
        "top_p": req.top_p,
        "eos_token_id": req.eos_token_id,
        "seed": req.seed,
        "seq_len": n,
        "block_refs": refs[:blocks_used],
        "kv_quant": cache.quant,
    }
    outbox = getattr(engine, "_handoff_outbox", None)
    if outbox is None:
        for i, (key, pool) in enumerate(pools):
            record[key] = gather(i, pool)
        sstate = engine.export_slot_sstate(slot)
        if sstate is not None:
            record["ssm_state"] = sstate
    else:
        planes = [(li, st["conv"][slot], st["ssm"][slot]) for li, st
                  in enumerate(getattr(engine, "_sstate", None) or [])
                  if st is not None]
        segs = [(key, (pool.shape[0], n) + tuple(pool.shape[2:]),
                 pool.dtype) for key, pool in pools]
        for i, (_, conv, ssm) in enumerate(planes):
            segs += [(f"ssm_state.{i}.conv", tuple(conv.shape), conv.dtype),
                     (f"ssm_state.{i}.ssm", tuple(ssm.shape), ssm.dtype)]
        ipc, views = outbox.reserve(segs)
        try:
            for i, ((_, pool), out) in enumerate(zip(pools, views)):
                gather(i, pool, out)
            rest = views[len(pools):]
            for i, (_, conv, ssm) in enumerate(planes):
                rest[2 * i].copy_(conv)
                rest[2 * i + 1].copy_(ssm)
        except BaseException:
            outbox.discard(ipc["generation"])
            raise
        ipc["ssm_layers"] = [li for li, _, _ in planes]
        record["ipc"] = ipc
    _sync(cache.device)         # written before any peer may read it
    st = handoff_stats(engine)
    st["exports"] += 1
    st["export_s"] += time.perf_counter() - t0
    return record


def _is_hybrid_record(record) -> bool:
    if "ssm_state" in record:
        return True
    ipc = record.get("ipc")
    return bool(ipc) and any(s["key"].startswith("ssm_state")
                             for s in ipc["segments"])


def install_handoff(engine, record: Dict[str, Any], request=None):
    """Place a handoff record onto a decode engine: allocate a slot and
    blocks, write the pages, adopt the refcounts, and register the request
    as already prefilled (its next step decodes ``generated[-1]``).
    ``request``: the request object a server's handle streams from (None
    builds one from the record). Returns the request, or None when the
    engine lacks a free slot or blocks (the record stays usable). A record
    that carries an IPC descriptor is pulled first (:class:`IPCInbox`);
    a pull the source does not confirm raises :class:`HandoffRefused`
    with the slot freed."""
    from paddle_tpu_torch.inference.engine import (GenerationRequest,
                                                   _warn_once)
    hybrid = getattr(engine, "_sstate", None) is not None
    if hybrid != _is_hybrid_record(record):
        # a hybrid engine must receive recurrent state and an attention-
        # only engine has nowhere to put it: refuse, the router replays
        _warn_once("kv handoff",
                   "SSM-state mismatch between handoff record and engine "
                   "(hybrid vs attention-only) — install refused")
        return None
    cache = engine.cache
    n = int(record["seq_len"])
    slot = cache.allocate_slot()
    if slot is None:
        return None
    if not cache.ensure_capacity(slot, n):
        cache.free_slot(slot)
        return None
    if record.get("ipc") is not None:
        try:
            record = _inbox_of(engine).pull(record, handoff_stats(engine))
        except HandoffRefused:
            cache.free_slot(slot)
            handoff_stats(engine)["refused"] += 1
            raise
    t0 = time.perf_counter()
    slots = cache.slot_mapping(slot, 0, n)
    rec_quant = record.get("kv_quant")
    k, v = torch.as_tensor(record["k"]), torch.as_tensor(record["v"])
    if rec_quant is not None and rec_quant == cache.quant:
        # one quant mode on both ends: pages and scales land as they are
        cache.write_all_quantized(k, v, torch.as_tensor(record["k_scale"]),
                                  torch.as_tensor(record["v_scale"]), slots)
    elif rec_quant is not None:
        # quantized -> full width, or int8 <-> fp8: restore full width
        # once; write_all quantizes again for a quantized pool
        from paddle_tpu_torch.quantization import kv as _kvq
        dev = cache.device
        cache.write_all(
            _kvq.dequantize_kv(k.to(dev),
                               torch.as_tensor(record["k_scale"]).to(dev)),
            _kvq.dequantize_kv(v.to(dev),
                               torch.as_tensor(record["v_scale"]).to(dev)),
            slots)
    else:
        cache.write_all(k, v, slots)
    cache.seq_lens[slot] = n
    cache.set_block_refs(slot, record.get("block_refs") or [])
    if hybrid:
        engine.install_slot_sstate(slot, record["ssm_state"])
    req = request if request is not None else GenerationRequest(
        record["request_id"], record["prompt"],
        max_new_tokens=int(record["max_new_tokens"]),
        temperature=record.get("temperature", 0.0),
        top_k=record.get("top_k", 0),
        top_p=record.get("top_p", 1.0),
        eos_token_id=record.get("eos_token_id"),
        seed=record.get("seed"))
    # the sampling noise hashes (seed, len(output_ids), column): both come
    # over exactly, so a sampled stream continues as if never moved
    req.output_ids = list(record.get("generated") or [])
    req.slot = slot
    req._prompt_pos = len(req.input_ids)
    if req.seed is None:
        req.seed = engine._seed_counter
        engine._seed_counter += 1
    engine._requests[req.request_id] = req
    engine._slot_req[slot] = req
    _sync(cache.device)
    st = handoff_stats(engine)
    st["installs"] += 1
    st["install_s"] += time.perf_counter() - t0
    return req


# ------------------------------------------------- serialized reference
def pack_handoff(record: Dict[str, Any]) -> bytes:
    """Wire-serialize a record: ``u64 header_len | header JSON | k bytes |
    v bytes | [k_scale, v_scale bytes] | [each SSM layer's conv, ssm
    bytes]``, the JAX package's format. A record that carries an IPC
    descriptor packs its header alone (``"ipc"`` in place of the bytes)."""
    header = {key: record.get(key) for key in _META_KEYS}
    header["version"] = record.get("version", HANDOFF_VERSION)
    if record.get("ipc") is not None:
        header["ipc"] = record["ipc"]
        blob = json.dumps(header, default=str).encode()
        return struct.pack(">Q", len(blob)) + blob
    k = torch.as_tensor(record["k"])
    header["shape"] = list(k.shape)
    header["page_dtype"] = _dtype_name(k.dtype)
    payload = [_bytes_of(k), _bytes_of(torch.as_tensor(record["v"]))]
    if record.get("kv_quant") is not None:
        ks = torch.as_tensor(record["k_scale"])
        header["scale_shape"] = list(ks.shape)
        header["scale_dtype"] = _dtype_name(ks.dtype)
        payload += [_bytes_of(ks),
                    _bytes_of(torch.as_tensor(record["v_scale"]))]
    if record.get("ssm_state"):
        meta = []
        for p in record["ssm_state"]:
            conv, ssm = torch.as_tensor(p["conv"]), torch.as_tensor(p["ssm"])
            meta.append({"layer": int(p["layer"]),
                         "conv_shape": list(conv.shape),
                         "conv_dtype": _dtype_name(conv.dtype),
                         "ssm_shape": list(ssm.shape),
                         "ssm_dtype": _dtype_name(ssm.dtype)})
            payload += [_bytes_of(conv), _bytes_of(ssm)]
        header["ssm_layers"] = meta
    blob = json.dumps(header, default=str).encode()
    return b"".join([struct.pack(">Q", len(blob)), blob] + payload)


def _take(buf: bytearray, off: int, shape, dtype: torch.dtype
          ) -> Tuple[torch.Tensor, int]:
    count = int(np.prod(shape)) if len(shape) else 1
    n = count * torch.empty((), dtype=dtype).element_size()
    if n == 0:
        return torch.empty(tuple(shape), dtype=dtype), off
    t = torch.frombuffer(buf, dtype=torch.uint8, count=n, offset=off)
    return t.view(dtype).reshape(tuple(shape)), off + n


def unpack_handoff(data: bytes) -> Dict[str, Any]:
    """Inverse of :func:`pack_handoff` (and of the JAX package's): arrays
    come back as CPU tensors, bit for bit. A header-only record keeps its
    ``"ipc"`` descriptor and has no arrays."""
    (hlen,) = struct.unpack(">Q", data[:8])
    header = json.loads(bytes(data[8:8 + hlen]).decode())
    if "ipc" in header:
        return header
    buf = bytearray(data)          # one writable copy the tensors view
    record = dict(header)
    shape = tuple(record.pop("shape"))
    dtype = _torch_dtype(record.pop("page_dtype"))
    off = 8 + hlen
    record["k"], off = _take(buf, off, shape, dtype)
    record["v"], off = _take(buf, off, shape, dtype)
    if record.get("kv_quant") is not None:
        sshape = tuple(record.pop("scale_shape"))
        sdtype = _torch_dtype(record.pop("scale_dtype"))
        record["k_scale"], off = _take(buf, off, sshape, sdtype)
        record["v_scale"], off = _take(buf, off, sshape, sdtype)
    layers = record.pop("ssm_layers", None)
    if layers:
        planes = []
        for m in layers:
            conv, off = _take(buf, off, m["conv_shape"],
                              _torch_dtype(m["conv_dtype"]))
            ssm, off = _take(buf, off, m["ssm_shape"],
                             _torch_dtype(m["ssm_dtype"]))
            planes.append({"layer": int(m["layer"]), "conv": conv,
                           "ssm": ssm})
        record["ssm_state"] = planes
    return record


# ------------------------------------------------ device to device (#18)
def dma_handoff_enabled(engine=None) -> bool:
    """The device-to-device transport: an engine on a CUDA device with
    ``use_pallas_kernels`` set (the reference's switch for its remote-DMA
    transport). False on the CPU, where the serialized path carries the
    handoff."""
    if engine is None or engine.cache.device.type != "cuda":
        return False
    return bool(flags.flag("use_pallas_kernels"))


def _rpc(endpoint: str, path: str, payload: Dict[str, Any],
         timeout: float = 10.0) -> bool:
    """POST to the source host; True when it answered ``ok``."""
    try:
        req = _urlreq.Request(
            endpoint.rstrip("/") + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with _urlreq.urlopen(req, timeout=timeout) as r:
            return bool(json.loads(r.read()).get("ok"))
    except Exception:                               # noqa: BLE001
        return False


class IPCOutbox:
    """The prefill host's side of the device-to-device route: exported
    device buffers holding staged records until a decode host confirms its
    pull of that generation. Buffers return to a pool on release and are
    reused, so a decode host maps each allocation once.

    :meth:`reserve` runs on the serving-loop thread (inside
    :func:`export_handoff`); :meth:`hold`,
    :meth:`release` and :meth:`discard` on HTTP handler threads, which
    touch only this table."""

    def __init__(self, device, endpoint: str = "", host: str = ""):
        self.device = torch.device(device)
        self.endpoint, self.host = endpoint, host
        self._lock = threading.Lock()
        self._pool: List[Dict[str, Any]] = []   # allocations, free or not
        self._held: Dict[int, Dict[str, Any]] = {}   # generation -> alloc
        self._gen = itertools.count(1)
        self.counters = {"staged": 0, "released": 0, "discarded": 0}

    def _alloc(self, need: int) -> Dict[str, Any]:
        free = [a for a in self._pool if a["gen"] is None
                and a["cap"] >= need]
        if free:
            return min(free, key=lambda a: a["cap"])
        cap = -(-need // _GRAIN) * _GRAIN
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        _launch.launch("ptt_ipc_alloc", self.device.index or 0, cap,
                       ctypes.byref(ptr), handle)
        a = {"ptr": ptr.value, "handle": handle.raw.hex(), "cap": cap,
             "gen": None}
        self._pool.append(a)
        return a

    def reserve(self, segments: List[Tuple[str, Tuple[int, ...],
                                           torch.dtype]]
                ) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
        """Hold a buffer for a record's segments ``[(key, shape, dtype),
        ...]`` under a new generation: the record's ``"ipc"`` descriptor,
        and one view of the buffer for each segment (256-byte aligned, in
        order) for the export to gather into. The caller synchronises its
        stream before it publishes the descriptor."""
        offs, sizes, total = [], [], 0
        for _, shape, dtype in segments:
            offs.append(total)
            sizes.append(math.prod(shape) * dtype.itemsize)
            total += -(-sizes[-1] // _ALIGN) * _ALIGN
        with self._lock:
            a = self._alloc(max(total, 1))
            gen = next(self._gen)
            a["gen"] = gen
            self._held[gen] = a
            self.counters["staged"] += 1
        buf = _k18.device_view(a["ptr"], a["cap"], self.device)
        views = [buf[off:off + size].view(dtype).view(shape)
                 for (_, shape, dtype), off, size
                 in zip(segments, offs, sizes)]
        ipc = {"handle": a["handle"], "generation": gen,
               "endpoint": self.endpoint, "host": self.host,
               "segments": [{"key": key, "offset": off, "shape": list(shape),
                             "dtype": _dtype_name(dtype)}
                            for (key, shape, dtype), off
                            in zip(segments, offs)]}
        return ipc, views

    def hold(self, generation: int) -> bool:
        """Whether ``generation`` is still staged (the pull may start)."""
        with self._lock:
            return int(generation) in self._held

    def _free(self, generation: int, counter: str) -> bool:
        with self._lock:
            a = self._held.pop(int(generation), None)
            if a is None:
                return False
            a["gen"] = None
            self.counters[counter] += 1
            return True

    def release(self, generation: int) -> bool:
        """A decode host confirms its pull of ``generation``: the buffer
        returns to the pool. False when that generation is not held."""
        return self._free(generation, "released")

    def discard(self, generation: int) -> bool:
        """Drop a staged record nobody will pull (the router gave it up)."""
        return self._free(generation, "discarded")

    @property
    def held(self) -> int:
        with self._lock:
            return len(self._held)


class IPCInbox:
    """The decode host's side: peers' exported buffers mapped into this
    process (once per allocation, closed when their source stops
    answering), and the pull of a descriptor record's segments with #18."""

    def __init__(self, device, chunks: int = 2):
        self.device = torch.device(device)
        self.chunks = int(chunks)
        self._maps: Dict[str, Tuple[int, str]] = {}  # handle -> (ptr, src)

    def _map(self, handle: str, endpoint: str) -> int:
        got = self._maps.get(handle)
        if got is None:
            ptr = ctypes.c_void_p()
            _launch.launch("ptt_ipc_open", self.device.index or 0,
                           bytes.fromhex(handle), ctypes.byref(ptr))
            got = self._maps[handle] = (ptr.value, endpoint)
        return got[0]

    def forget(self, endpoint: str) -> None:
        """Close every mapping of ``endpoint``'s buffers."""
        for handle, (ptr, src) in list(self._maps.items()):
            if src == endpoint:
                del self._maps[handle]
                try:
                    _launch.launch("ptt_ipc_close", self.device.index or 0,
                                   ptr)
                except RuntimeError:
                    pass         # the exporter is gone with its memory

    def pull(self, record: Dict[str, Any], stats=None) -> Dict[str, Any]:
        """The record with its arrays pulled onto this device: hold the
        source's generation, launch #18 once a segment on the current
        stream, synchronise, and release. Raises :class:`HandoffRefused`
        when the source does not confirm either side of the pull."""
        t0 = time.perf_counter()
        d = record["ipc"]
        src, gen = d["endpoint"], int(d["generation"])
        if not _rpc(src, "/ipc/hold", {"generation": gen}):
            self.forget(src)
            raise HandoffRefused(f"source {d.get('host') or src} does not "
                                 f"hold generation {gen}")
        base = self._map(d["handle"], src)
        arrays = {}
        with counters_lock:
            for seg in d["segments"]:
                out = torch.empty(tuple(seg["shape"]),
                                  dtype=_torch_dtype(seg["dtype"]),
                                  device=self.device)
                rows = out.shape[0] if out.dim() else 1
                _k18.pages_copy(out, base + int(seg["offset"]),
                                _k18.clamp_chunks(self.chunks, rows))
                arrays[seg["key"]] = out
            _sync(self.device)      # pulled before the source may reuse it
            if not _rpc(src, "/ipc/release", {"generation": gen}):
                self.forget(src)
                raise HandoffRefused(
                    f"source {d.get('host') or src} did not confirm "
                    f"generation {gen} after the pull")
            if stats is not None:
                stats["pulls"] += 1
                stats["segments"] += len(d["segments"])
                stats["pull_s"] += time.perf_counter() - t0
        out = {k: v for k, v in record.items() if k != "ipc"}
        for key in ("k", "v", "k_scale", "v_scale"):
            if key in arrays:
                out[key] = arrays[key]
        planes = {}
        for key, t in arrays.items():
            if key.startswith("ssm_state."):
                _, i, name = key.split(".")
                planes.setdefault(int(i), {})[name] = t
        if planes:
            layers = d.get("ssm_layers") or []
            out["ssm_state"] = [dict(planes[i], layer=int(layers[i]))
                                for i in sorted(planes)]
        return out


def _inbox_of(engine) -> IPCInbox:
    """The engine's inbox, made at its first IPC record; an engine that
    cannot take the device-to-device route refuses the record."""
    if not dma_handoff_enabled(engine):
        raise HandoffRefused(
            "an IPC handoff record reached an engine without the device-"
            "to-device route (a CPU engine, or use_pallas_kernels unset)")
    inbox = getattr(engine, "_handoff_inbox", None)
    if inbox is None:
        inbox = engine._handoff_inbox = IPCInbox(engine.cache.device)
    return inbox
