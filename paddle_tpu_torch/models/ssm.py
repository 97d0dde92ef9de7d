"""Hybrid attention + state-space (Mamba-2 / SSD) causal LM (port of
``paddle_tpu/models/ssm.py``).

SSM mixer layers and Llama attention layers alternate by
``SSMConfig.layer_pattern``. A mixer's prefill runs the chunked SSD scan
(:mod:`paddle_tpu_torch.ops.kernels.selective_scan`: the kernel on CUDA,
its twin on the CPU) and hands back the final ``(conv_state, ssm_state)``
that the serving engine's O(1) decode recurrence continues from, in place
of growing KV pages.

The hybrid reuses the Llama building blocks unchanged
(:class:`~paddle_tpu_torch.models.llama.LlamaDecoderLayer`,
:class:`~paddle_tpu_torch.models.llama.LlamaRMSNorm`). The inner stack is
``.llama`` so that the engine's ``model.llama.layers`` walk covers hybrid
models: SSM layers are known by their ``mixer``, attention layers by
``self_attn``. Parameter names and shapes are the reference's one to one,
so :func:`paddle_tpu_torch.weights.load_jax_state` carries a JAX hybrid's
weights across.

Dtypes (``ssm.py:252-261``): in a bf16 model the norms and the mixer's
``dt_bias``, ``A_log``, ``D`` and ``norm_weight`` stay fp32; they feed
exp/softplus and the fp32 state directly. (The reference's ``set_value``
keeps those four in bf16 after ``astype``; ROADMAP.md section C.)

Training runs on CUDA through the scan's backward kernel
(:class:`~paddle_tpu_torch.ops.kernels.selective_scan.ScanFunction`), and
``SSMConfig.recompute`` runs each layer of a model in training mode under
:func:`paddle_tpu_torch.autograd.recompute` (``ssm.py:290-291``).

Not ported yet: sequence parallelism and ``hybrid_ssm_shard_fn``
(ROADMAP.md A.10).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.autograd import recompute
from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.framework.random import seed as _seed
from paddle_tpu_torch.incubate.nn import functional as F_inc
from paddle_tpu_torch.models.llama import (LlamaDecoderLayer, LlamaRMSNorm,
                                           _Init, _shifted_lm_loss)
from paddle_tpu_torch.nn import Embedding
from paddle_tpu_torch.nn.initializer import Constant
from paddle_tpu_torch.ops.kernels import selective_scan as _ss

__all__ = ["SSMConfig", "Mamba2Block", "SSMDecoderLayer", "HybridSSMModel",
           "HybridSSMForCausalLM", "ssm_tiny_config"]


@dataclass
class SSMConfig:
    """Duck-types :class:`~paddle_tpu_torch.models.llama.LlamaConfig` (the
    attention layers read the shared fields) plus the Mamba-2 mixer
    geometry."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    dtype: str = "float32"
    recompute: bool = False
    # LlamaDecoderLayer compatibility (always off for the hybrid)
    moe_num_experts: int = 0
    sequence_parallel: bool = False
    # SSM mixer geometry (Mamba-2 defaults)
    ssm_state_size: int = 128       # d_state shared across heads
    ssm_head_dim: int = 64          # per-head channel count
    ssm_expand: int = 2             # d_inner = expand * hidden
    ssm_conv_kernel: int = 4        # causal depthwise conv width
    ssm_dt_min: float = 0.001
    ssm_dt_max: float = 0.1
    # tiled to num_hidden_layers: 'S' an SSM mixer layer, 'A' a Llama
    # attention+MLP layer
    layer_pattern: str = "SA"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.hidden_size

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def resolved_pattern(self) -> str:
        """The per-layer 'S'/'A' string, tiled to the layer count."""
        pat = (self.layer_pattern or "S").upper()
        bad = set(pat) - {"S", "A"}
        if bad:
            raise ValueError(f"layer_pattern may only contain 'S' and 'A', "
                             f"got {sorted(bad)}")
        reps = -(-self.num_hidden_layers // len(pat))
        return (pat * reps)[: self.num_hidden_layers]


def ssm_tiny_config(**overrides) -> SSMConfig:
    """Test-size config (the reference's ``ssm_tiny_config``)."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=8, max_position_embeddings=128,
                rope_theta=10000.0, ssm_state_size=16, ssm_head_dim=16,
                ssm_expand=2, layer_pattern="SA")
    base.update(overrides)
    return SSMConfig(**base)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """Paddle's ``softplus`` (beta 1, threshold 20) with JAX's
    ``logaddexp(x, 0)`` below the threshold, as the reference computes it."""
    return torch.where(x > 20.0, x, torch.logaddexp(x, torch.zeros_like(x)))


class Mamba2Block(nn.Module):
    """Gated SSD mixer (Mamba-2): one in-projection gives the gate ``z``,
    the conv stream ``[x, B, C]`` and the per-head step sizes ``dt``; a
    causal depthwise conv smooths the stream; the selective scan mixes
    time; a gated RMSNorm and the out-projection close the block."""

    def __init__(self, config: SSMConfig, init: _Init):
        super().__init__()
        self.config = config
        h, di = config.hidden_size, config.ssm_d_inner
        ds, nh = config.ssm_state_size, config.ssm_num_heads
        k = config.ssm_conv_kernel
        if di % config.ssm_head_dim:
            raise ValueError(f"ssm_d_inner {di} must divide by ssm_head_dim "
                             f"{config.ssm_head_dim}")
        self.conv_dim = di + 2 * ds
        dev, f32 = init.device, torch.float32
        # z | x | B | C | dt in one projection (Mamba-2's zxbcdt)
        self.in_proj = init.linear(h, 2 * di + 2 * ds + nh)
        self.conv_weight = nn.Parameter(
            init.normal((self.conv_dim, k), init.dtype, dev, init.generator))
        self.conv_bias = nn.Parameter(
            torch.zeros(self.conv_dim, dtype=init.dtype, device=dev))
        # softplus(dt_bias) spans [dt_min, dt_max] log-uniformly
        dts = np.exp(np.linspace(math.log(config.ssm_dt_min),
                                 math.log(config.ssm_dt_max), nh))
        self.dt_bias = nn.Parameter(torch.tensor(
            np.log(np.expm1(dts)), dtype=f32, device=dev))
        # A = -exp(A_log): the S4D-real 1..nh band of decay rates
        self.A_log = nn.Parameter(torch.tensor(
            np.log(np.arange(1, nh + 1)), dtype=f32, device=dev))
        self.D = nn.Parameter(Constant(1.0)((nh,), f32, dev))
        self.norm_weight = nn.Parameter(Constant(1.0)((di,), f32, dev))
        self.out_proj = init.linear(di, h)

    def _split(self, zxbcdt):
        cfg = self.config
        di, nh = cfg.ssm_d_inner, cfg.ssm_num_heads
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di:di + self.conv_dim]
        dt = zxbcdt[..., di + self.conv_dim:di + self.conv_dim + nh]
        return z, xbc, dt

    def _conv(self, xbc):
        """Causal depthwise conv over the sequence (kernel width k, one tap
        set per channel), padded by ``k-1`` zeros. Returns the activated
        stream and the conv state (the last ``k-1`` raw positions) that
        decode continues from."""
        k = self.config.ssm_conv_kernel
        b, l, cdim = xbc.shape
        pad = torch.zeros(b, k - 1, cdim, dtype=xbc.dtype, device=xbc.device)
        xpad = torch.cat([pad, xbc], dim=1)                 # b, l+k-1, cdim
        w = self.conv_weight.to(xbc.dtype)
        out = xpad[:, 0:l] * w[:, 0]
        for i in range(1, k):
            out = out + xpad[:, i:i + l] * w[:, i]
        out = torch.nn.functional.silu(out + self.conv_bias.to(xbc.dtype))
        return out, xpad[:, l:]

    def _mix(self, hidden_states):
        cfg = self.config
        b, l, _ = hidden_states.shape
        di, ds = cfg.ssm_d_inner, cfg.ssm_state_size
        nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
        z, xbc, dt_raw = self._split(self.in_proj(hidden_states))
        xconv, conv_state = self._conv(xbc)
        x_in = xconv[..., :di]
        B = xconv[..., di:di + ds]
        C = xconv[..., di + ds:]
        dt = _softplus(dt_raw.float() + self.dt_bias.float())
        A = -torch.exp(self.A_log.float())
        x_heads = x_in.reshape(b, l, nh, hd)
        y, ssm_state = _ss.selective_scan(x_heads, dt, A, B, C)
        y = y + x_heads * self.D.to(y.dtype).reshape(1, 1, nh, 1)
        y = y.reshape(b, l, di)
        y = F_inc.fused_rms_norm(y * torch.nn.functional.silu(z),
                                 self.norm_weight, cfg.rms_norm_eps)
        out = self.out_proj(y.to(self.out_proj.weight.dtype))
        return out, conv_state, ssm_state

    def forward(self, hidden_states):
        return self._mix(hidden_states)[0]

    def forward_with_state(self, hidden_states):
        """Prefill form: ``(out, conv_state [b, k-1, conv_dim], ssm_state
        [b, nh, ds, hd] fp32)``."""
        return self._mix(hidden_states)


class SSMDecoderLayer(nn.Module):
    """Pre-norm residual SSM layer, ``h + Mamba2Block(RMSNorm(h))``; the
    mixer subsumes the MLP."""

    def __init__(self, config: SSMConfig, init: _Init):
        super().__init__()
        self.config = config
        self.input_layernorm = LlamaRMSNorm(config, init)
        self.mixer = Mamba2Block(config, init)

    def forward(self, hidden_states):
        return hidden_states + self.mixer(self.input_layernorm(hidden_states))


class HybridSSMModel(nn.Module):
    def __init__(self, config: SSMConfig, init: _Init):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      initializer=init.normal,
                                      dtype=init.dtype, device=init.device,
                                      generator=init.generator)
        self.layers = nn.ModuleList(
            [SSMDecoderLayer(config, init) if ch == "S"
             else LlamaDecoderLayer(config, init)
             for ch in config.resolved_pattern()])
        self.norm = LlamaRMSNorm(config, init)

    def forward(self, input_ids):
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            if self.config.recompute and self.training:
                h = recompute(layer, h)
            else:
                h = layer(h)
        return self.norm(h)


class HybridSSMForCausalLM(nn.Module):
    """Hybrid SSM/attention causal LM: ``forward(input_ids [b, s]) ->
    logits [b, s, vocab]``; with ``labels``, the fp32 next-token loss and
    the shifted logits. ``device`` defaults to CUDA (raising without one);
    weights are drawn from ``generator``, or from one seeded with
    ``seed``, on that device."""

    def __init__(self, config: SSMConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        if config.sequence_parallel:
            raise NotImplementedError(
                "SSMConfig.sequence_parallel is not ported yet (ROADMAP.md "
                "A.10)")
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = _seed(seed, dev)
        init = _Init(config, dev, generator)
        self.config = config
        self.llama = HybridSSMModel(config, init)
        self.lm_head = (None if config.tie_word_embeddings
                        else init.linear(config.hidden_size,
                                         config.vocab_size))

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def logits(self, hidden):
        if self.lm_head is not None:
            return self.lm_head(hidden)
        return hidden @ self.llama.embed_tokens.weight.to(hidden.dtype).t()

    def forward(self, input_ids, labels: Optional[torch.Tensor] = None):
        logits = self.logits(self.llama(input_ids))
        if labels is None:
            return logits
        return _shifted_lm_loss(logits, labels)
