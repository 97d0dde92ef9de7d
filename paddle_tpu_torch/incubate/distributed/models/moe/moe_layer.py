"""MoELayer (port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``, one device).

The experts' parameters are stacked into one ``[E, ...]`` leaf per weight
on a submodule ``stacked`` (``gate_proj__weight``, ``up_proj__weight``,
``down_proj__weight``), so the state-dict keys are the JAX layer's. The
forward is the reference's grouped path (``moe_layer.py:52-96``): the
gate's score product (``torch.matmul``, as the reference leaves it to
XLA), its index routing, the sort-based dispatch into an expert-major
buffer, the expert MLP as grouped GEMMs (the CUDA kernels on CUDA
tensors, their twins on CPU tensors) and the weighted combine. The aux
loss of the routing is left on ``gate._loss``.

Not ported yet, each raising ``NotImplementedError`` by ROADMAP.md item:
expert parallelism (a mesh, ``shard_experts``, the all-to-all dispatch;
A.10), recompute (A.3), and, A.8, experts other than bias-free SwiGLU
MLPs, gates without index routing, and the index-form and dense paths
(``moe_grouped_gemm=off``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddle_tpu_torch.incubate.distributed.models.moe.gate import (
    BaseGate, GShardGate, NaiveGate, SwitchGate)
from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

__all__ = ["MoELayer"]

_GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate}
_SWIGLU = ["down_proj.weight", "gate_proj.weight", "up_proj.weight"]


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"MoELayer: {what} is not ported yet "
                               f"(ROADMAP.md {item})")


class MoELayer(nn.Module):
    """``MoELayer(d_model, experts, gate="gshard")``: ``experts`` is a list
    of structurally identical bias-free SwiGLU MLPs (``gate_proj``,
    ``up_proj``, ``down_proj``); their weights are copied into the stacked
    leaves. A gate given by name is built in the experts' dtype and on
    their device, its weight drawn from ``generator``.

    ``forward(x [..., M])`` returns the combined expert output in x's
    shape; ``layer.gate.get_loss()`` is the routing's aux loss."""

    def __init__(self, d_model: int, experts: Sequence[nn.Module],
                 gate="gshard", capacity_factor: Optional[float] = None,
                 mesh=None, ep_axis: str = "ep", recompute_interval: int = 0,
                 moe_group=None, mp_group=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not experts:
            raise ValueError("MoELayer needs at least one expert")
        if mesh is not None or moe_group is not None or mp_group is not None:
            raise _unported("expert parallelism (mesh, moe_group, mp_group)",
                            "A.10")
        if recompute_interval > 0:
            raise _unported("recompute_interval", "A.3")
        template = experts[0]
        names = [n for n, _ in template.named_parameters()]
        if sorted(names) != _SWIGLU:
            raise _unported(f"experts other than bias-free SwiGLU MLPs "
                            f"(params {sorted(names)})", "A.8")
        self.d_model = d_model
        self.num_experts = len(experts)
        ref = template.gate_proj.weight
        if isinstance(gate, str):
            gate = _GATES[gate](d_model, self.num_experts, dtype=ref.dtype,
                                device=ref.device, generator=generator)
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a BaseGate or one of "
                            f"{sorted(_GATES)}, got {gate!r}")
        if type(gate).route_indices is BaseGate.route_indices:
            raise _unported(f"gate {type(gate).__name__} without index "
                            f"routing (the dense route path)", "A.8")
        self.gate = gate
        self.capacity_factor = (capacity_factor if capacity_factor
                                is not None
                                else getattr(gate, "capacity_factor", 1.0))
        self.stacked = nn.Module()
        for name in names:
            leaves = []
            for exp in experts:
                params = dict(exp.named_parameters())
                if name not in params:
                    raise ValueError(
                        f"experts are not structurally identical: '{name}' "
                        f"missing from expert {type(exp).__name__}")
                leaves.append(params[name].detach())
            self.stacked.register_parameter(
                name.replace(".", "__"), nn.Parameter(torch.stack(leaves)))
        self._param_names = names

    def expert_parameters(self):
        """``(names, stacked [E, ...] parameters)``."""
        params = [getattr(self.stacked, n.replace(".", "__"))
                  for n in self._param_names]
        return list(self._param_names), params

    def shard_experts(self, mesh, ep_axis: Optional[str] = None):
        raise _unported("shard_experts (expert parallelism)", "A.10")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.gate
        top_k = getattr(gate, "top_k", 1)
        shape = x.shape
        m = shape[-1]
        tokens = x.reshape(-1, m)
        n = tokens.shape[0]
        stacked = self.stacked
        wg = stacked.gate_proj__weight
        wu = stacked.up_proj__weight
        wd = stacked.down_proj__weight
        num_e = wg.shape[0]
        capacity = gate.capacity(n, self.capacity_factor, top_k)
        scores = torch.matmul(tokens, gate.weight.to(tokens.dtype))
        e_idx, slot, w, keep, aux = gate.route_indices(scores.float(),
                                                       capacity)
        ct = torch.promote_types(tokens.dtype, wg.dtype)
        gg.require_grouped_path(ct)
        x_buf, counts, dest = gg.sorted_dispatch(
            tokens.to(ct), e_idx, slot, keep, num_e,
            gg.padded_capacity(capacity))
        y_buf = gg.expert_mlp(x_buf, counts, wg, wu, wd)
        y = gg.sorted_combine(y_buf, dest, w, keep, n)
        gate._loss = aux.float()
        return y.reshape(shape[:-1] + (y.shape[-1],))
