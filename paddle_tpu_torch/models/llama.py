"""Llama-3 family decoder (port of ``paddle_tpu/models/llama.py``).

A decoder layer runs one of the reference's two paths, chosen by the
``pallas_fused_block`` flag:

* fused (``on``/``auto``): RMSNorm -> q/k/v projections -> neox RoPE,
  then the fused block kernel (attention, o-projection + residual,
  RMSNorm, SwiGLU MLP + residual in one launch);
* composed (``off``, or a layer the kernel cannot take): RMSNorm -> q/k/v
  -> RoPE -> causal GQA attention -> o-projection + residual -> RMSNorm
  -> SwiGLU MLP + residual.

With ``moe_num_experts > 0`` the MLP is a
:class:`~paddle_tpu_torch.incubate.distributed.models.moe.MoELayer` over
``LlamaMLP`` experts (the grouped-GEMM kernels; the index form under
``moe_grouped_gemm=off``); the fused block refuses such a layer, as the
reference's does, so it composes.

On CUDA the norms, attention, the fused block and the grouped GEMMs run
the hand-written kernels, forward and backward; on CPU their plain twins.
``forward(ids, labels)`` returns the fp32 next-token loss, plus
``moe_aux_weight`` times each MoE layer's aux loss. With
``sequence_parallel`` and a mesh that has the ``sep_axis`` axis,
attention runs the context-parallel ring over that axis
(:func:`~paddle_tpu_torch.distributed.ring_attention`: the zig-zag ring
over the segment-causal kernels when ``sep_mode`` is ``auto`` and the
sequence divides ``2*sp``); the rest of the layer runs replicated on
every rank of the axis, and such a layer never takes the fused block.
With a global mesh that has an ``ep`` axis, every MoE layer takes the
expert-parallel a2a dispatch, or the all-gather path where the flags turn
it off; :func:`llama_shard_fn` (for ``distributed.shard_layer``) keeps each
rank's block of the experts.
Weights keep Paddle's
``[in, out]`` layout and are trainable, norm weights stay fp32 in a bf16
model, and the state-dict keys are the JAX model's, so
:func:`paddle_tpu_torch.weights.load_jax_state` carries a JAX model's
weights across unchanged.

With ``LlamaConfig.recompute`` each decoder layer of a model in training
mode runs under :func:`paddle_tpu_torch.autograd.recompute`
(``llama.py:322-323``), dense and MoE alike.

Not ported yet (ROADMAP.md A): Ulysses sequence parallelism and the
numerics taps.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.autograd import recompute
from paddle_tpu_torch.framework.dtype import to_torch_dtype
from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.framework.random import seed as _seed
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.incubate.nn import functional as F_inc
from paddle_tpu_torch.nn import Embedding, Linear
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.initializer import Constant, Normal
from paddle_tpu_torch.ops.kernels import fused_block as _fb

__all__ = ["LlamaConfig", "LlamaRMSNorm", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "llama_tiny_config", "llama3_8b_config", "llama_shard_fn"]


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
    # MoE (DeepSeekMoE / Qwen2-MoE family): > 0 replaces the dense MLP with
    # a MoELayer of that many LlamaMLP experts
    moe_num_experts: int = 0
    moe_gate: str = "gshard"
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    sequence_parallel: bool = False
    # the mesh axis the ring runs over, and how: "auto" (the zig-zag ring
    # when seq % (2*sp) == 0, else the contiguous ring), "ring", "zigzag"
    # or "ulysses" (not ported: ROADMAP.md A.10)
    sep_axis: str = "sep"
    sep_mode: str = "auto"
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


# one warning per structural reason per process, as in the reference: the
# composed path for a layer the fused block cannot take is loud once
_warned_fused: set = set()


def _warn_fused_fallback(reason: str) -> None:
    if reason in _warned_fused:
        return
    _warned_fused.add(reason)
    warnings.warn(f"pallas_fused_block: falling back to the composed "
                  f"decoder path — {reason}", RuntimeWarning, stacklevel=3)


class LlamaRMSNorm(nn.Module):
    """RMSNorm with a trainable fp32 weight in every model dtype
    (``llama.py:241``)."""

    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.weight = nn.Parameter(
            Constant(1.0)((config.hidden_size,), torch.float32,
                          init.device))
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

    def qkv_rope(self, hidden_states):
        """Projections and RoPE only: the fused block takes q, k and v
        and runs attention in its own kernel (``llama.py:151-165``)."""
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
        return q, k, v

    def forward(self, hidden_states):
        """``llama.py:171-200``: with ``sequence_parallel`` and a mesh
        that has the sep axis, the ring over that axis; else the flash
        kernels."""
        cfg = self.config
        b, s, _ = hidden_states.shape
        q, k, v = self.qkv_rope(hidden_states)
        mesh = dist.get_mesh() if cfg.sequence_parallel else None
        if mesh is not None and cfg.sep_axis in mesh.dim_names:
            mode = cfg.sep_mode
            if mode not in ("auto", "ring", "zigzag", "ulysses"):
                raise ValueError(
                    f"sep_mode must be 'auto', 'ring', 'zigzag' or "
                    f"'ulysses', got {cfg.sep_mode!r}")
            if mode == "auto":
                # causal decoder attention: the balanced zig-zag ring
                # whenever the sequence admits it
                sp = mesh.get_dim_size(cfg.sep_axis)
                mode = "zigzag" if int(s) % (2 * sp) == 0 else "ring"
            if mode == "ulysses":
                out = dist.ulysses_attention(q, k, v, causal=True,
                                             mesh=mesh,
                                             sp_axis=cfg.sep_axis)
            else:
                out = dist.ring_attention(
                    q, k, v, causal=True, mesh=mesh, sp_axis=cfg.sep_axis,
                    layout="zigzag" if mode == "zigzag" else "contig")
        else:
            out = scaled_dot_product_attention(q, k, v, is_causal=True,
                                               training=self.training)
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
    """A decoder layer: the fused block where the flag and the layer's
    shape allow it, else the composed path (``llama.py:249-296``)."""

    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.config = config
        self.input_layernorm = LlamaRMSNorm(config, init)
        self.self_attn = LlamaAttention(config, init)
        self.post_attention_layernorm = LlamaRMSNorm(config, init)
        if config.moe_num_experts > 0:
            self.mlp = MoELayer(
                config.hidden_size,
                [LlamaMLP(config, init)
                 for _ in range(config.moe_num_experts)],
                gate=config.moe_gate,
                capacity_factor=config.moe_capacity_factor,
                generator=init.generator)
        else:
            self.mlp = LlamaMLP(config, init)

    def _fused_forward(self, hidden_states):
        """The layer through the fused block kernel when the
        ``pallas_fused_block`` flag and the layer shape allow it, None
        otherwise (the caller composes). The input norm and q/k/v
        projections stay outside: they feed the kernel."""
        if not F_inc.fused_block_enabled():
            return None
        cfg = self.config
        if isinstance(self.mlp, MoELayer):
            _warn_fused_fallback("MoE mlp (fused block supports dense "
                                 "layers only)")
            return None
        if cfg.sequence_parallel:
            # the kernel's attention is single-device: the layer would
            # silently skip the ring (``llama.py:263-264``)
            _warn_fused_fallback("sequence-parallel attention runs over "
                                 "the mesh")
            return None
        b, s, hidden = hidden_states.shape
        reason = _fb.ineligible_reason(
            (b, s, cfg.num_attention_heads, cfg.head_dim),
            (b, s, cfg.num_key_value_heads, cfg.head_dim), hidden,
            self.mlp.gate_proj.weight.shape[-1], hidden_states.dtype,
            hidden_states.device)
        if reason is not None:
            _warn_fused_fallback(reason)
            return None
        q, k, v = self.self_attn.qkv_rope(
            self.input_layernorm(hidden_states))
        return F_inc.fused_block(
            q, k, v, hidden_states, self.post_attention_layernorm.weight,
            self.self_attn.o_proj.weight, self.mlp.gate_proj.weight,
            self.mlp.up_proj.weight, self.mlp.down_proj.weight,
            cfg.rms_norm_eps)

    def forward(self, hidden_states):
        fused = self._fused_forward(hidden_states)
        if fused is not None:
            return fused
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
            if self.config.recompute and self.training:
                h = recompute(layer, h)
            else:
                h = layer(h)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Causal LM: ``forward(input_ids [b, s]) -> logits [b, s, vocab]``,
    and ``forward(input_ids, labels) -> (loss, shifted_logits)`` for
    training.

    ``device`` defaults to CUDA (raising without one); weights are drawn
    from ``generator``, or from a generator seeded with ``seed``, on that
    device.
    """

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 seed: int = 0):
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

    def forward(self, input_ids, labels: Optional[torch.Tensor] = None):
        """The logits, differentiable as the reference's are; with
        ``labels``, the fp32 next-token loss and the shifted logits
        (``llama.py:354-368``). Serving and scoring callers wrap the call
        in ``torch.no_grad()``."""
        moe = [m for m in self.modules() if isinstance(m, MoELayer)]
        # the last forward's aux losses go first: each holds that forward's
        # autograd graph, which would otherwise live into this one (and a
        # graph kept from a step's eager run blocks its CUDA-graph capture)
        for m in moe:
            m.gate._loss = None
        logits = self.logits(self.llama(input_ids))
        if labels is None:
            return logits
        loss, shifted = _shifted_lm_loss(logits, labels)
        # the routing load-balance penalty of every MoE layer
        # (``llama.py:360-367``)
        for m in moe:
            if m.gate.get_loss() is not None:
                loss = loss + self.config.moe_aux_weight * m.gate.get_loss()
        return loss, shifted


def _shifted_lm_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Next-token LM loss (``llama.py:371-409``): the logits of positions
    ``0..s-2`` against the labels of ``1..s-1``, an fp32 logsumexp per
    token, ``ignore_index=-100`` tokens dropped, averaged over the valid
    tokens (never below a count of 1). Returns ``(loss, shifted_logits)``.
    Plain torch, as the reference leaves it to XLA."""
    shifted = logits[:, :-1, :]
    lb = labels[:, 1:].long()
    valid = lb != -100
    safe = torch.where(valid, lb, torch.zeros_like(lb))
    lf = shifted.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    per_tok = torch.where(valid, lse - picked, torch.zeros_like(lse))
    denom = valid.sum().float().clamp(min=1.0)
    return per_tok.sum() / denom, shifted


def llama_shard_fn(mesh, dp_axis: str = "dp", mp_axis: str = "mp",
                   ep_axis: str = "ep"):
    """The placement table of ``paddle_tpu/models/llama.py:526-575`` for
    ``distributed.shard_layer``, its expert-parallel part: every MoE
    layer's stacked expert leaves ``Shard(0)`` over ``ep_axis``
    (:meth:`MoELayer.shard_experts`); every other parameter stays
    replicated. The Megatron tensor-parallel placements over ``mp_axis``
    and data parallelism over ``dp_axis`` are ROADMAP.md A.10."""
    for axis in (dp_axis, mp_axis):
        if axis in mesh.dim_names:
            raise NotImplementedError(
                f"llama_shard_fn: the {axis!r} axis (data and tensor "
                f"parallel placements) is not ported yet (ROADMAP.md A.10)")

    def shard_fn(name, sub, mesh_):
        if isinstance(sub, MoELayer) and ep_axis in mesh_.dim_names:
            sub.shard_experts(mesh_, ep_axis)

    return shard_fn
