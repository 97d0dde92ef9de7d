"""Carry a JAX model's weights into the port.

:func:`load_jax_state` takes the JAX ``LlamaForCausalLM.state_dict()`` as
numpy arrays (``{name: np.asarray(p.numpy())}``) and copies each into the
port's parameter of the same name. Keys, shapes (Paddle's ``[in, out]``
Linear layout) and dtypes match one to one; norm weights are fp32, the
rest in the config dtype. Nothing is transposed or cast, but for the one
exact widening :func:`load_jax_state` names. Hybrid SSM models
(``models/ssm.py``) cross the same way.

JAX bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so they cross as their raw 16 bits:
``.view(np.uint16)`` -> ``torch.from_numpy`` -> ``.view(torch.bfloat16)``.

A model whose MoE layers keep only this rank's experts
(``MoELayer.shard_experts``, ``llama_shard_fn``) takes this rank's block of
each JAX ``[E, ...]`` expert array; :func:`gather_experts` puts the ranks'
blocks back together.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["load_jax_state", "to_torch", "gather_experts"]


def _expert_shards(model: torch.nn.Module) -> Dict[str, Tuple]:
    """``{parameter name: (rank, ep, layer)}`` of every stacked expert leaf
    that holds one rank's block of its layer's experts."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    out = {}
    for prefix, sub in model.named_modules():
        if isinstance(sub, MoELayer) and sub.expert_shard is not None:
            rank, ep = sub.expert_shard
            for name, _ in sub.stacked.named_parameters():
                key = f"{prefix}.stacked.{name}" if prefix \
                    else f"stacked.{name}"
                out[key] = (rank, ep, sub)
    return out


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (including ``ml_dtypes.bfloat16``) -> CPU torch tensor,
    bitwise."""
    a = np.array(a, copy=True, order="C")     # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_jax_state(model: torch.nn.Module,
                   np_state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Fill ``model``'s parameters from a JAX state dict of numpy arrays.

    Raises on a missing or unexpected key, a shape mismatch or a dtype
    mismatch — a silently cast or transposed weight would make every
    later comparison meaningless. The one exception is exact: a bf16
    array widens into an fp32 parameter, value for value (a JAX bf16
    hybrid keeps its mixer's ``dt_bias``, ``A_log``, ``D`` and
    ``norm_weight`` in bf16 where the port keeps them fp32; ROADMAP.md
    section C). A stacked expert leaf that holds rank ``r``'s block of
    ``E/ep`` experts takes experts ``r*E/ep`` to ``(r+1)*E/ep - 1`` of the
    JAX ``[E, ...]`` array."""
    params = dict(model.named_parameters())
    shards = _expert_shards(model)
    missing = sorted(set(params) - set(np_state))
    extra = sorted(set(np_state) - set(params))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, unexpected "
                       f"{extra}")
    with torch.no_grad():
        for name, p in params.items():
            src = to_torch(np.asarray(np_state[name]))
            if name in shards:
                rank, ep, _ = shards[name]
                e_l = src.shape[0] // ep
                if src.shape[0] % ep == 0 and e_l == p.shape[0]:
                    src = src[rank * e_l:(rank + 1) * e_l]
            widen = (src.dtype == torch.bfloat16
                     and p.dtype == torch.float32)
            if tuple(src.shape) != tuple(p.shape) or (
                    src.dtype != p.dtype and not widen):
                raise ValueError(
                    f"{name}: JAX {tuple(src.shape)} {src.dtype} vs port "
                    f"{tuple(p.shape)} {p.dtype}")
            p.copy_(src.to(p.dtype))
    return model


def gather_experts(model: torch.nn.Module,
                   values: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``model`` by name, the expert shards all-gathered
    back to ``[E, ...]`` over their layer's ep group (collective: every
    rank of the group calls it). ``values`` (e.g. the gradients, by
    parameter name) replaces the parameters."""
    from paddle_tpu_torch.distributed import collective
    shards = _expert_shards(model)
    values = values if values is not None else {
        n: p.detach() for n, p in model.named_parameters()}
    out = {}
    for name, t in values.items():
        if name in shards:
            layer = shards[name][2]
            t = collective.all_gather(t.contiguous(),
                                      layer._mesh.group(layer._ep_axis),
                                      axis=0)
        out[name] = t
    return out
