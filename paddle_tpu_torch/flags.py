"""Runtime flag registry (port of ``paddle_tpu/flags.py``).

Only the flags this port reads are defined. Each is overridable from the
environment (``FLAGS_<name>=...``) at import and mutable at runtime with
:func:`set_flags`. No flag makes a kernel wrapper fall back: on a CUDA
tensor a wrapper launches its kernel or raises. ``pallas_fused_block``
keeps the reference's name and chooses between two model paths, each of
which runs kernels; so does ``moe_fused_wi`` (gmm2, or two gmm launches).
``pallas_selective_scan=off`` takes the reference's associative scan on
CPU tensors and raises on CUDA tensors, where that path has no kernel.
``pallas_async_a2a=off`` likewise takes the backend's exchange (the
reference's ``lax.all_to_all``) on CPU tensors and raises on CUDA tensors;
``moe_a2a_fused_kernel=off`` takes the composed pipelined path, whose
exchanges and GEMMs are kernels again.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "flag", "flag_default", "get_flags", "set_flags"]

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}

_FLAGS: Dict[str, Any] = {}
_DEFAULTS: Dict[str, Any] = {}


def _parse(raw: str, default: Any) -> Any:
    if isinstance(default, bool):
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"cannot parse boolean flag value {raw!r}")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def define_flag(name: str, default: Any) -> None:
    if name in _FLAGS:
        raise ValueError(f"flag {name!r} already defined")
    env = os.environ.get(f"FLAGS_{name}")
    _DEFAULTS[name] = default
    _FLAGS[name] = default if env is None else _parse(env, default)


def flag(name: str) -> Any:
    try:
        return _FLAGS[name]
    except KeyError:
        raise KeyError(f"unknown flag {name!r}") from None


def flag_default(name: str) -> Any:
    try:
        return _DEFAULTS[name]
    except KeyError:
        raise KeyError(f"unknown flag {name!r}") from None


def get_flags(names) -> Dict[str, Any]:
    """``{name: value}`` of the named flags (a name or a list of them)."""
    if isinstance(names, str):
        names = [names]
    return {n: flag(n) for n in names}


def set_flags(values: Dict[str, Any]) -> None:
    for name, value in values.items():
        default = _DEFAULTS.get(name, KeyError)
        if default is KeyError:
            raise KeyError(f"unknown flag {name!r}")
        if (isinstance(default, (bool, int, float, str))
                and not isinstance(value, type(default))):
            value = _parse(str(value), default)
        _FLAGS[name] = value


# serving options the engine reads: prompt-lookup drafts a decoding
# sequence carries (0 = off), the refcounted prefix cache, quantized KV pages
# ("off", "int8", "fp8", "auto"/"on" = int8), the host-RAM KV tier with its
# byte budget (whole blocks; under one block the tier has no room and
# allocation evicts) and whether a parked slot's restore is staged one step
# ahead (off: restored inline, the same tokens one step earlier), and
# weight-only int8 projections
define_flag("serve_spec_tokens", 0)
define_flag("serve_prefix_cache", False)
define_flag("serve_kv_quant", "off")
define_flag("serve_kv_host_tier", False)
define_flag("serve_kv_host_bytes", 1 << 30)
define_flag("serve_kv_restore_ahead", True)
define_flag("serve_weight_quant", False)

# the fused decoder block (ops/kernels/fused_block.py) in LlamaDecoderLayer:
# "auto" takes it (the CUDA kernel for CUDA tensors, its plain twin for CPU
# tensors); "on" is an alias of "auto", kept for the reference's callers,
# since the port has no interpret mode for "on" to force on the CPU; "off"
# keeps the composed per-op path. A layer the kernel cannot take composes
# with a one-time warning, as in the reference.
define_flag("pallas_fused_block", "auto")

# the SSM mixers' prefill scan (ops/kernels/selective_scan.py): "auto" and
# its alias "on" take the chunked form (the CUDA kernel for CUDA tensors,
# its chunked twin for CPU tensors); "off" takes the associative-scan path
# on CPU tensors and raises NotImplementedError on CUDA tensors
define_flag("pallas_selective_scan", "auto")

# the MoE expert path (ops/kernels/grouped_gemm.py: fast_path_enabled):
# "auto" and "on" take the grouped GEMMs on every device (the CUDA kernels
# for CUDA tensors, their twins for CPU tensors) where the experts are
# SwiGLU MLPs that opt in and the dtype is fp32 or bf16; "off" takes the
# reference's index-form scatter/vmap path (composed PyTorch, as the
# reference composes it), which also serves every other expert and dtype
define_flag("moe_grouped_gemm", "auto")
# gate and up projections of the expert MLP through the dual-output gmm2
# kernel (one read of the token buffer) instead of two gmm launches
define_flag("moe_fused_wi", True)

# expert parallelism (incubate/distributed/models/moe/moe_a2a.py,
# ops/kernels/async_collectives.py), with the reference's defaults
# (paddle_tpu/flags.py:173-210). moe_a2a_dispatch: "on" forces the
# capacity-bucketed ragged all-to-all on a mesh with an ep axis of size > 1
# (grouped experts only), "auto" follows moe_grouped_gemm as the
# reference's does, "off" turns it off: a layer holding one rank's experts
# then takes the all-gather path (every rank fills the whole buffer, runs
# its experts and all-gathers the outputs), one holding all of them the
# one-device path.
define_flag("moe_a2a_dispatch", "auto")
# split each rank's tokens into moe_a2a_chunks independent pipelines
# (clamped to the largest divisor of the rank's token count)
define_flag("moe_a2a_overlap", False)
define_flag("moe_a2a_chunks", 2)
# the tiled exchange inside ragged_all_to_all: "auto" and its alias "on"
# take the tiled all-to-all kernel on CUDA tensors (its twin, the collective
# exchange, on CPU tensors); "off" takes the collective exchange, the
# reference's lax.all_to_all, on CPU tensors and raises NotImplementedError
# on CUDA tensors, where the exchange is the kernel's
define_flag("pallas_async_a2a", "auto")
# the comm-fused dispatch + expert MLP kernel: "auto" and its alias "on"
# take it (the
# kernel on CUDA tensors, its composed twin on CPU tensors) at any chunk
# count; "off" takes the composed pipelined path. The reference's flag text
# says the kernel needs moe_a2a_overlap, but its code never checks it
# (ROADMAP.md C), and the port follows the code.
define_flag("moe_a2a_fused_kernel", "auto")

# the reference's master switch for its Pallas kernels. In the port every
# kernel wrapper launches on CUDA tensors whatever this says; the flag gates
# one thing, the KV handoff's transport (inference/kv_handoff.py:
# dma_handoff_enabled): set, two CUDA hosts move the pages device to device
# through the remote-copy kernel; unset, as packed bytes (ROADMAP.md C)
define_flag("use_pallas_kernels", True)

# request-scoped distributed tracing (observability/tracing.py): the context
# API runs; arming it raises until its span sink, the flight recorder and
# the JSONL stream, is ported (ROADMAP.md A.12)
define_flag("obs_trace", False)
define_flag("obs_trace_sample", 1.0)

# chaos flags of the serving plane (testing/fault_injection.py), with the
# reference's specs (paddle_tpu/flags.py:455-512): nothing fires unless
# fault_injection is armed
define_flag("fault_injection", False)
# 'delay:SECONDS' sleeps every serving-loop step; 'crash:N' raises
# SimulatedCrash on the Nth
define_flag("fault_serve_step", "")
# 'stall:ID' wedges request ID's stream consumer ('stall' alone: every one)
define_flag("fault_serve_client", "")
# 'storm:SECONDS' clamps every admitted request's timeout to SECONDS
define_flag("fault_serve_deadline", "")
# 'HOST:N' hard-kills host HOST's serving loop on its Nth iteration
define_flag("fault_serve_kill", "")
# 'drop:HOST' drops health posts and router reads of host HOST
define_flag("fault_router_partition", "")
# 'drop:N' (or 'N') strips the trace context from the Nth traced hop
define_flag("fault_trace_drop", "")
