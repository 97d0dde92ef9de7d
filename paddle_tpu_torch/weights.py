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

:func:`load_jax_optimizer_state` carries a JAX optimizer's
``state_dict()`` (numpy arrays, the ``LR_Scheduler`` dict as it is) into
the port's optimizer of the same kind. The JAX models leave parameter
names unset, so those keys are positional (``param_{i}_moment1``,
``master_weights.param_{i}``): it first checks that the port's model
lists its parameters in the JAX model's order, name by name and shape by
shape, and that the optimizer holds them in that order.

A ``MoELayer`` of any experts crosses the same way: each stacked leaf
(``stacked.gate_proj__weight``, ``stacked.bias``, ...) and the gate's weight,
a custom gate's included, under the JAX name. A model whose MoE layers keep
only this rank's experts (``MoELayer.shard_experts``, ``llama_shard_fn``)
takes this rank's block of each JAX ``[E, ...]`` expert array;
:func:`gather_experts` puts the ranks' blocks back together.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["load_jax_state", "load_jax_optimizer_state", "to_torch",
           "gather_experts", "param_digest"]


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


_PARAM_KEY = re.compile(r"param_(\d+)(?:_(.+))?$")


def load_jax_optimizer_state(opt, model: torch.nn.Module,
                             np_state: Dict,
                             jax_params: Sequence[Tuple[str, Sequence[int]]]
                             ) -> None:
    """Load a JAX optimizer's ``state_dict()`` into ``opt``.

    ``np_state`` holds numpy arrays (bf16 as ``ml_dtypes.bfloat16``) under
    the JAX keys, and the scheduler's dict under ``LR_Scheduler``;
    ``jax_params`` is the JAX model's ``[(name, shape), ...]`` in its
    parameter order (``[(n, p.shape) for n, p in jm.named_parameters()]``).
    Raises, before anything is written, on a parameter order that
    differs from the JAX model's (the positional keys would land on the
    wrong parameters), an optimizer that does not hold ``model``'s
    parameters in that order, a key it cannot place, and a shape or dtype
    mismatch. Accumulators and masters not made yet wait for the first
    step, as ``set_state_dict`` keeps them."""
    port = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    jax = [(n, tuple(s)) for n, s in jax_params]
    if port != jax:
        diff = next((i, a, b) for i, (a, b) in enumerate(
            zip(port + [None] * len(jax), jax + [None] * len(port)))
            if a != b)
        raise ValueError(f"parameter order differs from the JAX model's at "
                         f"position {diff[0]}: port {diff[1]}, JAX {diff[2]}")
    params = list(model.parameters())
    if [id(p) for p in opt._parameter_list] != [id(p) for p in params]:
        raise ValueError("the optimizer does not hold the model's parameters "
                         "in the model's order")

    def expect(key, value, shape, dtype):
        t = to_torch(np.asarray(value))
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{key}: JAX {tuple(t.shape)} {t.dtype} vs port "
                             f"{tuple(shape)} {dtype}")
        return t

    def param_of(key, i):
        if i >= len(params):
            raise KeyError(f"{key}: the model has {len(params)} parameters")
        return params[i]

    acc_names = set(opt._ACC_NAMES)
    state = {}
    for key, value in np_state.items():
        if key == "LR_Scheduler":
            if opt._lr_scheduler is None:
                raise KeyError("LR_Scheduler: the optimizer has no scheduler")
            state[key] = dict(value)
        elif key == "global_step":
            state[key] = expect(key, value, (), torch.int32)
        elif key.startswith("master_weights."):
            m = _PARAM_KEY.match(key[len("master_weights."):])
            if m is None or m.group(2) is not None:
                raise KeyError(f"{key}: no parameter of that key")
            p = param_of(key, int(m.group(1)))
            if not opt._use_master(p):
                raise KeyError(f"{key}: the port keeps no master for a "
                               f"{p.dtype} parameter (multi_precision="
                               f"{opt._use_master_weights})")
            state[key] = expect(key, value, p.shape, torch.float32)
        else:
            m = _PARAM_KEY.match(key)
            if m is None or m.group(2) not in acc_names:
                raise KeyError(f"{key}: not a state key of "
                               f"{type(opt).__name__} (accumulators "
                               f"{sorted(acc_names)})")
            p = param_of(key, int(m.group(1)))
            state[key] = expect(key, value, p.shape, opt._acc_dtype(p))
    opt.set_state_dict(state)


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


_DIGEST_SLAB = 1 << 24


def param_digest(model: torch.nn.Module) -> str:
    """A hash of every parameter's bits, computed where the parameters
    live: each tensor's raw words (bf16 as int16, fp32 as int32) summed
    plainly and against a pseudo-random weight of each absolute position
    (so no two positions of a tensor share one), in int64 on the device,
    slab by slab; the sums, with the names, shapes
    and dtypes, go through SHA-256. Two models with equal digests hold the
    same bits (a difference that cancels in both sums is vanishingly
    unlikely), and no host copy of the weights is made."""
    import hashlib
    h = hashlib.sha256()
    positions = {}
    for name, p in model.named_parameters():
        t = p.detach().reshape(-1)
        word = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[t.element_size()]
        bits = t.view(word)
        dev = bits.device
        i = positions.get(dev)
        if i is None:
            i = positions[dev] = torch.arange(_DIGEST_SLAB, dtype=torch.int64,
                                              device=dev)
        s1 = torch.zeros((), dtype=torch.int64, device=dev)
        s2 = torch.zeros((), dtype=torch.int64, device=dev)
        for a in range(0, bits.numel(), _DIGEST_SLAB):
            x = bits[a:a + _DIGEST_SLAB].to(torch.int64)
            w = ((i[:x.numel()] + a) * 2654435761 + 40503) % 2147483629 + 1
            s1 += x.sum()
            s2 += (x * w).sum()
        h.update(f"{name}:{tuple(p.shape)}:{p.dtype}:{int(s1)}:{int(s2)};"
                 .encode())
    return h.hexdigest()
