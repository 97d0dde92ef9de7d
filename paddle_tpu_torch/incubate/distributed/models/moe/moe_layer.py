"""MoELayer (port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

The experts' parameters are stacked into one ``[E, ...]`` leaf per weight
on a submodule ``stacked`` (``gate_proj__weight``, ``up_proj__weight``,
``down_proj__weight``), so the state-dict keys are the JAX layer's. The
forward is the reference's grouped path (``moe_layer.py:52-96``): the
gate's score product (``torch.matmul``, as the reference leaves it to
XLA), its index routing, the sort-based dispatch into an expert-major
buffer, the expert MLP as grouped GEMMs (the CUDA kernels on CUDA
tensors, their twins on CPU tensors) and the weighted combine. The aux
loss of the routing is left on ``gate._loss``.

Expert parallelism (``moe_layer.py:231-264``): on a mesh (``mesh=``, else
the global mesh) with an ``ep`` axis of size > 1, the layer takes the
ragged all-to-all dispatch of :mod:`.moe_a2a` while ``moe_a2a_dispatch``
is on; :meth:`MoELayer.shard_experts` keeps this rank's ``E/ep`` experts.
A mesh the a2a path cannot take warns once per reason and runs the
one-device path over all experts, as the reference falls back to its
all-gather path; a layer without a mesh, or whose mesh has no ``ep``
axis, is a one-device layer and does not warn.

Not ported yet, each raising ``NotImplementedError`` by ROADMAP.md item:
mesh axes beside ``ep``, ``moe_group``/``mp_group`` and the all-gather
path over sharded experts (A.10), and, A.8, ``recompute_interval`` (the
vmap path's), experts other than bias-free SwiGLU MLPs, gates without
index routing, and the index-form and dense paths
(``moe_grouped_gemm=off``). A model's ``recompute`` wraps whole layers
(:func:`paddle_tpu_torch.autograd.recompute`).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch
from torch import nn

from paddle_tpu_torch.distributed.process_mesh import get_mesh
from paddle_tpu_torch.incubate.distributed.models.moe import moe_a2a
from paddle_tpu_torch.incubate.distributed.models.moe.gate import (
    BaseGate, GShardGate, NaiveGate, SwitchGate)
from paddle_tpu_torch.ops.kernels import grouped_gemm as gg

__all__ = ["MoELayer"]

_GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate}
_SWIGLU = ["down_proj.weight", "gate_proj.weight", "up_proj.weight"]


# one warning per distinct structural reason per process
_warned_fallbacks: set = set()


def _warn_fallback(what: str, reason: str) -> None:
    key = (what, reason)
    if key in _warned_fallbacks:
        return
    _warned_fallbacks.add(key)
    warnings.warn(f"{what}: falling back to the slow path — {reason}",
                  RuntimeWarning, stacklevel=3)


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
    shape; ``layer.gate.get_loss()`` is the routing's aux loss. With
    ``mesh`` (a mesh of the ``ep_axis`` axis alone) the layer runs expert
    parallel over that mesh; without it, over the global mesh if that has
    the axis."""

    def __init__(self, d_model: int, experts: Sequence[nn.Module],
                 gate="gshard", capacity_factor: Optional[float] = None,
                 mesh=None, ep_axis: str = "ep", recompute_interval: int = 0,
                 moe_group=None, mp_group=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not experts:
            raise ValueError("MoELayer needs at least one expert")
        if moe_group is not None or mp_group is not None:
            raise _unported("moe_group and mp_group (the reference's "
                            "communicator groups)", "A.10")
        if mesh is not None:
            moe_a2a.require_ep_only(mesh, ep_axis, "MoELayer")
        if recompute_interval > 0:
            raise _unported("recompute_interval", "A.8")
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
        self._mesh = mesh
        self._ep_axis = ep_axis
        # (rank on the ep axis, ep) once shard_experts kept a block
        self.expert_shard: Optional[tuple] = None

    def expert_parameters(self):
        """``(names, stacked [E, ...] parameters)``."""
        params = [getattr(self.stacked, n.replace(".", "__"))
                  for n in self._param_names]
        return list(self._param_names), params

    def shard_experts(self, mesh, ep_axis: Optional[str] = None):
        """Keep this rank's block of the stacked experts, ``Shard(0)`` over
        the ep axis (``moe_layer.py:192``): rank ``r`` keeps experts
        ``r*E/ep`` to ``(r+1)*E/ep - 1``. Each leaf becomes a new
        parameter, so build the optimizer after this call."""
        ep_axis = ep_axis or self._ep_axis
        moe_a2a.require_ep_only(mesh, ep_axis, "MoELayer.shard_experts")
        if ep_axis not in mesh.dim_names:
            raise ValueError(f"shard_experts: mesh {mesh} has no "
                             f"{ep_axis!r} axis")
        ep, rank = mesh.get_dim_size(ep_axis), mesh.axis_index(ep_axis)
        if self.num_experts % ep:
            raise ValueError(f"shard_experts: {self.num_experts} experts do "
                             f"not split over ep={ep}")
        if self.expert_shard is not None:
            if self.expert_shard != (rank, ep):
                raise ValueError(f"shard_experts: already sharded as "
                                 f"{self.expert_shard}, not {(rank, ep)}")
            return self
        e_l = self.num_experts // ep
        for name in self._param_names:
            key = name.replace(".", "__")
            p = getattr(self.stacked, key)
            block = p.detach()[rank * e_l:(rank + 1) * e_l].clone()
            self.stacked.register_parameter(
                key, nn.Parameter(block, requires_grad=p.requires_grad))
        self._mesh, self._ep_axis = mesh, ep_axis
        self.expert_shard = (rank, ep)
        return self

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
        num_e = self.num_experts
        capacity = gate.capacity(n, self.capacity_factor, top_k)
        scores = torch.matmul(tokens, gate.weight.to(tokens.dtype))
        routed = gate.route_indices(scores.float(), capacity)
        e_idx, slot, w, keep, aux = routed
        ct = torch.promote_types(tokens.dtype, wg.dtype)
        gg.require_grouped_path(ct)
        mesh = self._mesh if self._mesh is not None else get_mesh()
        ep_axis = self._ep_axis
        if (mesh is not None and ep_axis in mesh.dim_names
                and moe_a2a.a2a_enabled()):
            reason = moe_a2a.a2a_ineligible_reason(mesh, ep_axis, num_e, n,
                                                   ffn=wg.shape[-1])
            if reason is None:
                y, gate._loss = moe_a2a.a2a_grouped_forward(
                    tokens, routed, wg, wu, wd, capacity, mesh, ep_axis,
                    shape, ct, num_experts=num_e)
                return y
            _warn_fallback("moe_a2a_dispatch", reason)
        if self.expert_shard is not None:
            raise _unported("the all-gather expert path over sharded experts "
                            "(moe_a2a_dispatch=off, or a mesh the a2a "
                            "dispatch cannot take)", "A.10")
        x_buf, counts, dest = gg.sorted_dispatch(
            tokens.to(ct), e_idx, slot, keep, num_e,
            gg.padded_capacity(capacity))
        y_buf = gg.expert_mlp(x_buf, counts, wg, wu, wd)
        y = gg.sorted_combine(y_buf, dest, w, keep, n)
        gate._loss = aux.float()
        return y.reshape(shape[:-1] + (y.shape[-1],))
