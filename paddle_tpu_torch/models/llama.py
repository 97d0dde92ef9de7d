"""Llama-3 family decoder (port of ``paddle_tpu/models/llama.py``).

The composed decoder path of the reference (``pallas_fused_block=off``):
RMSNorm -> q/k/v projections -> neox RoPE -> causal GQA attention ->
o-projection + residual -> RMSNorm -> SwiGLU MLP + residual. On CUDA the
norms run the RMSNorm forward kernel and attention the flash-attention
forward kernel; on CPU their plain twins. Weights keep Paddle's ``[in,
out]`` layout, norm weights stay fp32 in a bf16 model, and the state-dict
keys are the JAX model's, so :func:`paddle_tpu_torch.weights.load_jax_state`
carries a JAX model's weights across unchanged.

Not ported yet (ROADMAP.md A): the LM loss, recompute, MoE layers,
sequence parallelism, the fused decoder block, and the numerics taps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.framework.dtype import to_torch_dtype
from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.framework.random import seed as _seed
from paddle_tpu_torch.incubate.nn import functional as F_inc
from paddle_tpu_torch.nn import Embedding, Linear
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.initializer import Constant, Normal

__all__ = ["LlamaConfig", "LlamaRMSNorm", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "llama_tiny_config", "llama3_8b_config"]


@dataclass
class LlamaConfig:
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
    moe_num_experts: int = 0
    sequence_parallel: bool = False
    recompute: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_tiny_config(**overrides) -> LlamaConfig:
    """Test-size config (the reference's ``llama_tiny_config``)."""
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=8, max_position_embeddings=128,
                rope_theta=10000.0)
    base.update(overrides)
    return LlamaConfig(**base)


def llama3_8b_config(**overrides) -> LlamaConfig:
    """Llama-3-8B widths: hidden 4096, ffn 14336, 32 layers, GQA 32:8,
    vocab 128256, RoPE theta 5e5, bf16."""
    base = dict(vocab_size=128256, hidden_size=4096,
                intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8,
                max_position_embeddings=8192, rope_theta=500000.0,
                dtype="bfloat16")
    base.update(overrides)
    return LlamaConfig(**base)


class _Init:
    """What every layer needs to build its weights: dtype, device and the
    generator they are drawn from."""

    def __init__(self, config: LlamaConfig, device, generator):
        self.dtype = to_torch_dtype(config.dtype)
        self.device = device
        self.generator = generator
        self.normal = Normal(0.0, config.initializer_range)

    def linear(self, i: int, o: int) -> Linear:
        return Linear(i, o, initializer=self.normal, dtype=self.dtype,
                      device=self.device, generator=self.generator)


class LlamaRMSNorm(nn.Module):
    """RMSNorm with an fp32 weight in every model dtype (``llama.py:241``)."""

    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.weight = nn.Parameter(
            Constant(1.0)((config.hidden_size,), torch.float32,
                          init.device), requires_grad=False)
        self._eps = config.rms_norm_eps

    def forward(self, x):
        return F_inc.fused_rms_norm(x, self.weight, self._eps)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.config = config
        h, d = config.hidden_size, config.head_dim
        nh, nkv = config.num_attention_heads, config.num_key_value_heads
        self.q_proj = init.linear(h, nh * d)
        self.k_proj = init.linear(h, nkv * d)
        self.v_proj = init.linear(h, nkv * d)
        self.o_proj = init.linear(nh * d, h)

    def forward(self, hidden_states):
        cfg = self.config
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).reshape(
            b, s, cfg.num_attention_heads, cfg.head_dim)
        k = self.k_proj(hidden_states).reshape(
            b, s, cfg.num_key_value_heads, cfg.head_dim)
        v = self.v_proj(hidden_states).reshape(
            b, s, cfg.num_key_value_heads, cfg.head_dim)
        q, k, _ = F_inc.fused_rotary_position_embedding(
            q, k, use_neox_rotary_style=True,
            rotary_emb_base=cfg.rope_theta)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        h, f = config.hidden_size, config.intermediate_size
        self.gate_proj = init.linear(h, f)
        self.up_proj = init.linear(h, f)
        self.down_proj = init.linear(f, h)

    def forward(self, x):
        return self.down_proj(F_inc.swiglu(self.gate_proj(x),
                                           self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    """The composed decoder layer (``llama.py:290-296``)."""

    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.config = config
        self.input_layernorm = LlamaRMSNorm(config, init)
        self.self_attn = LlamaAttention(config, init)
        self.post_attention_layernorm = LlamaRMSNorm(config, init)
        self.mlp = LlamaMLP(config, init)

    def forward(self, hidden_states):
        h = hidden_states + self.self_attn(
            self.input_layernorm(hidden_states))
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      initializer=init.normal,
                                      dtype=init.dtype, device=init.device,
                                      generator=init.generator)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, init)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, init)

    def forward(self, input_ids):
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Causal LM: ``forward(input_ids [b, s]) -> logits [b, s, vocab]``.

    ``device`` defaults to CUDA (raising without one); weights are drawn
    from ``generator``, or from a generator seeded with ``seed``, on that
    device.
    """

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        for feature, on in (("moe_num_experts", config.moe_num_experts),
                            ("sequence_parallel", config.sequence_parallel),
                            ("recompute", config.recompute)):
            if on:
                raise NotImplementedError(
                    f"LlamaConfig.{feature} is not ported yet "
                    f"(ROADMAP.md A)")
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = _seed(seed, dev)
        init = _Init(config, dev, generator)
        self.config = config
        self.llama = LlamaModel(config, init)
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

    @torch.no_grad()
    def forward(self, input_ids):
        return self.logits(self.llama(input_ids))
