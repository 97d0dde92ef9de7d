"""MoELayer (port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

The experts are any structurally identical modules (``[M] -> [M]``); each
of their parameters is stacked into one ``[E, ...]`` leaf on a submodule
``stacked`` (``gate_proj__weight``, ``weight``, ``bias``: the expert's
parameter name with ``.`` as ``__``), so the state-dict keys are the JAX
layer's. A copy of the first expert, its parameters on ``meta``, is the
template the experts' forward runs through; it stays out of the layer's
parameters and state dict (``moe_layer.py:150``).

The forward (``moe_layer.py:184-307``) takes the gate's score product
(``torch.matmul``, as the reference leaves it to XLA), then one of three
routes, chosen from the flags, the gate, the experts and the dtype before
anything launches:

* the grouped path (``moe_grouped_gemm`` ``auto`` or ``on``; a gate with
  index routing; ``LlamaMLP`` experts, or experts whose class sets
  ``supports_grouped_gemm``, with the three bias-free SwiGLU weights): the
  sort-based dispatch into an expert-major buffer, the expert MLP as
  grouped GEMMs (the CUDA kernels on CUDA tensors, their twins on CPU
  tensors) and the weighted combine. A compute dtype the kernels do not
  take (fp16) warns once and takes the index form;
* the index form (``moe_grouped_gemm=off``, other experts, or a dtype the
  kernels refuse): the kept tokens scattered into ``[E, C, M]`` slots,
  every expert's own forward under ``torch.func.vmap`` over the stacked
  leaves (``torch.func.functional_call`` on the template), the slots
  gathered back with the gate weights;
* the dense route, for gates that give only ``route`` (no
  ``route_indices``): ``[N, E, C]`` dispatch and combine einsums around
  the same vmapped experts. It costs O(N·E·C·M); it is the path for custom
  gates, not a training path.

``recompute_interval > 0`` recomputes the experts in the backward: the
vmapped call (the index form and the dense route) or the grouped expert
MLP under a non-reentrant checkpoint. The aux loss of the routing is left
on ``gate._loss``.

Expert parallelism (``moe_layer.py:231-264``): on a mesh (``mesh=``, else
the global mesh) with an ``ep`` axis of size > 1, the layer takes the
ragged all-to-all dispatch of :mod:`.moe_a2a` when ``moe_a2a_dispatch``
allows it and the grouped path runs; :meth:`MoELayer.shard_experts` keeps
this rank's ``E/ep`` experts. A mesh the a2a path cannot take warns once
per reason. Off the a2a path, a layer that keeps one rank's block runs the
all-gather path (:func:`.moe_a2a.all_gather_experts`): every rank fills
the whole buffer of the grouped or index form from the replicated tokens,
runs its block and all-gathers the outputs. A layer holding all ``E``
experts runs the one-device path; one without a mesh, or whose mesh has no
``ep`` axis, does not warn.

Not ported yet, each raising ``NotImplementedError`` by ROADMAP.md item:
mesh axes beside ``ep`` and ``moe_group``/``mp_group`` (A.10). A model's
``recompute`` wraps whole layers (:func:`paddle_tpu_torch.autograd.recompute`).
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def _template(expert: nn.Module) -> nn.Module:
    """A copy of ``expert`` whose parameters are ``meta`` tensors: the
    structure ``functional_call`` runs with the stacked leaves bound in.
    Buffers are copied as they are."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                requires_grad=False)
            for p in expert.parameters()}
    return copy.deepcopy(expert, memo)


class MoELayer(nn.Module):
    """``MoELayer(d_model, experts, gate="gshard")``: ``experts`` is a list
    of structurally identical modules, each ``[..., M] -> [..., M]``; their
    parameters are copied into the stacked leaves. A gate given by name is
    built in the experts' dtype and on their device, its weight drawn from
    ``generator``.

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
        template = experts[0]
        names = [n for n, _ in template.named_parameters()]
        if not names:
            raise ValueError(f"MoELayer: expert {type(template).__name__} "
                             f"has no parameters to stack")
        self.d_model = d_model
        self.num_experts = len(experts)
        ref = next(template.parameters())
        if isinstance(gate, str):
            gate = _GATES[gate](d_model, self.num_experts, dtype=ref.dtype,
                                device=ref.device, generator=generator)
        if not isinstance(gate, BaseGate):
            raise TypeError(f"gate must be a BaseGate or one of "
                            f"{sorted(_GATES)}, got {gate!r}")
        self.gate = gate
        self.capacity_factor = (capacity_factor if capacity_factor
                                is not None
                                else getattr(gate, "capacity_factor", 1.0))
        self._recompute = recompute_interval > 0
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
        # unregistered: no parameter, state-dict entry or device move
        self.__dict__["_template"] = _template(template)
        # the grouped GEMMs compute a SwiGLU MLP: the parameter names AND
        # the class's opt-in, so that an expert that merely shares the
        # names but computes something else is never run as SwiGLU
        # (moe_layer.py:151-161)
        self._grouped_ok = (
            sorted(names) == _SWIGLU
            and (type(template).__name__ == "LlamaMLP"
                 or bool(getattr(template, "supports_grouped_gemm", False))))
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
        the ep axis (``moe_layer.py:168``): rank ``r`` keeps experts
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

    # ------------------------------------------------------------ routes
    def _experts(self, fn, buf, leaves):
        """``fn(buf, *leaves)`` under the recompute checkpoint when asked,
        on this rank's block through the all-gather path when the layer
        keeps one."""
        run = fn
        if self._recompute:
            def run(b, *ls):
                return checkpoint(fn, b, *ls, use_reentrant=False)
        if self.expert_shard is None:
            return run(buf, *leaves)
        return moe_a2a.all_gather_experts(run, buf, self._mesh,
                                          self._ep_axis, *leaves)

    def _run_experts(self, expert_in, stacked):
        """Every expert's own forward on its ``[C, M]`` slots of
        ``expert_in [E, C, M]``: the template through
        ``torch.func.functional_call`` under ``torch.func.vmap`` over the
        stacked leaves (``moe_layer.py:201-216``)."""
        template = self.__dict__["_template"]
        names = self._param_names

        def one(params, h):
            return torch.func.functional_call(
                template, dict(zip(names, params)), (h,))

        def vmapped(buf, *leaves):
            return torch.func.vmap(one)(leaves, buf)
        return self._experts(vmapped, expert_in, stacked)

    def _grouped(self, tokens, routed, stacked, capacity, ct):
        """The grouped path (``moe_layer.py:52-96``)."""
        e_idx, slot, w, keep, _ = routed
        wg, wu, wd = (stacked[self._param_names.index(k)] for k in
                      ("gate_proj.weight", "up_proj.weight",
                       "down_proj.weight"))
        c_pad = gg.padded_capacity(capacity)
        x_buf, counts, dest = gg.sorted_dispatch(
            tokens.to(ct), e_idx, slot, keep, self.num_experts, c_pad)
        if self.expert_shard is not None:
            rank, ep = self.expert_shard
            e_l = self.num_experts // ep
            counts = counts[rank * e_l:(rank + 1) * e_l]

        def mlp(xb, g, u, d):
            return gg.expert_mlp(xb, counts, g, u, d)
        y_buf = self._experts(mlp, x_buf, (wg, wu, wd))
        return gg.sorted_combine(y_buf, dest, w, keep, tokens.shape[0])

    def _index_form(self, tokens, routed, stacked, capacity):
        """The index-form path (``moe_layer.py:271-296``): the kept
        ``(token, k)`` pairs scattered into ``[E, C, M]``, the experts, the
        slots gathered back with the gate weights. Dropped pairs carry
        ``slot >= C`` and alias slot ``C-1`` after the clip, so ``keep``
        masks both the scattered payload and the gather weight. The
        scatter adds into zeros (``accumulate=True``): a kept slot receives
        one token and any number of zeros, so the sum is exact in any
        order, and a dropped pair cannot overwrite the occupant."""
        e_idx, slot, w, keep, _ = routed
        n, m = tokens.shape
        k = e_idx.shape[1]
        flat_e = e_idx.reshape(-1).long()
        flat_s = slot.reshape(-1).long().clamp(max=capacity - 1)
        keep_f = keep.reshape(-1).to(tokens.dtype)
        payload = tokens.repeat_interleave(k, dim=0) * keep_f[:, None]
        expert_in = tokens.new_zeros((self.num_experts, capacity, m)) \
            .index_put((flat_e, flat_s), payload, accumulate=True)
        expert_out = self._run_experts(expert_in, stacked)
        gathered = F.embedding(flat_e * capacity + flat_s,
                               expert_out.reshape(-1, expert_out.shape[-1]))
        wk = (w.reshape(-1).to(tokens.dtype) * keep_f)[:, None]
        return (gathered * wk).reshape(n, k, -1).sum(dim=1)

    def _dense(self, tokens, scores, stacked, capacity):
        """The dense route for gates without index routing
        (``moe_layer.py:297-305``); returns ``(y, aux)``."""
        combine, dispatch, aux = self.gate.route(scores, capacity)
        expert_in = torch.einsum("nm,nec->ecm", tokens,
                                 dispatch.to(tokens.dtype))
        expert_out = self._run_experts(expert_in, stacked)
        ct = torch.promote_types(expert_out.dtype, tokens.dtype)
        return torch.einsum("ecm,nec->nm", expert_out.to(ct),
                            combine.to(tokens.dtype).to(ct)), aux

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.gate
        top_k = getattr(gate, "top_k", 1)
        shape = x.shape
        m = shape[-1]
        tokens = x.reshape(-1, m)
        n = tokens.shape[0]
        names, stacked = self.expert_parameters()
        num_e = self.num_experts
        capacity = gate.capacity(n, self.capacity_factor, top_k)
        scores = torch.matmul(tokens, gate.weight.to(tokens.dtype)).float()
        try:
            routed = gate.route_indices(scores, capacity)
        except NotImplementedError:
            routed = None
        y = None
        if routed is not None and self._grouped_ok:
            wg = stacked[names.index("gate_proj.weight")]
            ffn = wg.shape[-1]
            ct = torch.promote_types(tokens.dtype, wg.dtype)
            mesh = self._mesh if self._mesh is not None else get_mesh()
            ep_axis = self._ep_axis
            if (mesh is not None and ep_axis in mesh.dim_names
                    and moe_a2a.a2a_enabled()):
                reason = moe_a2a.a2a_ineligible_reason(mesh, ep_axis, num_e,
                                                       n, ffn=ffn)
                if reason is None:
                    e_l = num_e // mesh.get_dim_size(ep_axis)
                    if (gg.eligible(e_l, capacity, m, ffn, ct)
                            and gg.eligible(e_l, capacity, ffn, m, ct)):
                        y, gate._loss = moe_a2a.a2a_grouped_forward(
                            tokens, routed, wg,
                            stacked[names.index("up_proj.weight")],
                            stacked[names.index("down_proj.weight")],
                            capacity, mesh, ep_axis, shape, ct,
                            num_experts=num_e, remat=self._recompute)
                        return y
                    reason = (f"grouped GEMM ineligible for the local "
                              f"expert shape (E_local={e_l}, capacity="
                              f"{capacity}, m={m}, ffn={ffn}, dtype={ct})")
                _warn_fallback("moe_a2a_dispatch", reason)
            if gg.fast_path_enabled():
                if (gg.eligible(num_e, capacity, m, ffn, ct)
                        and gg.eligible(num_e, capacity, ffn, m, ct)):
                    y = self._grouped(tokens, routed, stacked, capacity, ct)
                else:
                    _warn_fallback(
                        "moe_grouped_gemm",
                        f"the grouped GEMMs compute in fp32 or bf16, not "
                        f"{ct} (E={num_e}, capacity={capacity}, m={m}, "
                        f"ffn={ffn}): the index-form path runs")
        if y is not None:
            aux = routed[4]
        elif routed is not None:
            y, aux = self._index_form(tokens, routed, stacked, capacity), \
                routed[4]
        else:
            y, aux = self._dense(tokens, scores, stacked, capacity)
        gate._loss = aux.float()
        return y.reshape(shape[:-1] + (y.shape[-1],))
