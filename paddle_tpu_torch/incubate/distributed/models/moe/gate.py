"""MoE gates (port of ``paddle_tpu/incubate/distributed/models/moe/gate.py``).

A gate maps token scores ``[N, E]`` to index-form routing: ``(expert_idx
[N, K], slot [N, K], weight [N, K], keep [N, K], aux)``. All routing math
is branch-free tensor code, as in the reference: top-k through one-hot
masks, the slot of a token in its expert through a cumsum of those masks.
The reference's fp32 cumsum holds integers below 2**24, which the port
sums in int32 to the same values, and ``argmax`` takes the first maximum
in both frameworks: equal scores route equally.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.nn.initializer import XavierUniform

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _positions_in_expert(mask: torch.Tensor) -> torch.Tensor:
    """Per-expert arrival order of the tokens selected by ``mask`` ([N, E]
    one-hot, 0/1 values): cumsum along tokens, 0-based. Summed in int32,
    which gives the fp32 cumsum's integer values exactly and is a
    deterministic CUDA op (the floating-point cumsum is not), and along
    the contiguous dim of the transposed ``[E, N]`` mask: CUDA scans an
    outer dim one column per thread, which at 16 experts took ~3 ms for
    16,384 tokens on an H100."""
    counts = torch.cumsum(mask.t().contiguous().to(torch.int32), dim=1,
                          dtype=torch.int32)
    return counts.t().to(mask.dtype) - mask


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    """The reference's ``exp(s - max) / sum`` (not ``torch.softmax``, whose
    rounding may differ in the last bit and flip a near-tie argmax)."""
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[arange(n), idx]``."""
    return t.gather(1, idx[:, None]).squeeze(1)


class BaseGate(nn.Module):
    """Common gate surface: a ``[d_model, num_experts]`` score weight
    (XavierUniform, drawn from ``generator`` in ``dtype`` on ``device``),
    the capacity rule and the auxiliary loss of the last forward."""

    def __init__(self, d_model: int, num_experts: int, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.weight = nn.Parameter(XavierUniform()(
            (d_model, num_experts), dtype, resolve_device(device), generator))
        self._loss = None

    def get_loss(self):
        """Auxiliary load-balance loss of the LAST forward."""
        return self._loss

    def capacity(self, num_tokens: int, capacity_factor: float,
                 top_k: int) -> int:
        c = int(math.ceil(top_k * num_tokens / self.num_experts
                          * capacity_factor))
        return max(c, 1)

    def route_indices(self, scores: torch.Tensor, capacity: int,
                      valid: Optional[torch.Tensor] = None) -> Tuple:
        """``(expert_idx [N, K] int32, slot [N, K] int32, weight [N, K],
        keep [N, K] bool, aux)`` for fp32 ``scores [N, E]``. ``valid [N]``
        (bool) masks tokens out of routing: they take no capacity slot and
        are never kept."""
        raise NotImplementedError

    def route(self, scores: torch.Tensor, capacity: int) -> Tuple:
        """Dense ``(combine [N, E, C], dispatch, aux)`` routing, derived from
        :meth:`route_indices` so that the two forms cannot diverge."""
        e_idx, slot, w, keep, aux = self.route_indices(scores, capacity)
        n, k = e_idx.shape
        rows = torch.arange(n, device=scores.device).repeat_interleave(k)
        wk = (w * keep.to(w.dtype)).reshape(-1)
        combine = torch.zeros((n, self.num_experts, capacity),
                              dtype=scores.dtype, device=scores.device)
        # a dropped token adds its weight 0 at the clipped slot: a no-op
        combine.index_put_((rows, e_idx.reshape(-1).long(),
                            slot.reshape(-1).long().clamp(max=capacity - 1)),
                           wk, accumulate=True)
        return combine, combine > 0, aux


class NaiveGate(BaseGate):
    """Top-k routing without an aux loss (reference ``NaiveGate``)."""

    def __init__(self, d_model, num_experts, top_k: int = 2, **kw):
        super().__init__(d_model, num_experts, **kw)
        self.top_k = top_k

    def route_indices(self, scores, capacity, valid=None):
        n, e = scores.shape
        vf = None if valid is None else valid.to(scores.dtype)[:, None]
        probs = _softmax(scores)
        remaining = probs
        occupancy = torch.zeros((1, e), dtype=scores.dtype,
                                device=scores.device)
        idxs, slots, ws, keeps = [], [], [], []
        for _ in range(self.top_k):
            idx = remaining.argmax(dim=-1)
            mask = _one_hot(idx, e, scores.dtype)
            if vf is not None:
                mask = mask * vf
            pos = (_positions_in_expert(mask) + occupancy) * mask
            occupancy = occupancy + mask.sum(dim=0, keepdim=True)
            my_pos = _pick(pos, idx)
            keep = my_pos < capacity
            if valid is not None:
                keep = keep & valid
            idxs.append(idx.to(torch.int32))
            slots.append(my_pos.to(torch.int32))
            keeps.append(keep)
            ws.append((probs * mask).sum(-1))
            remaining = remaining * (1.0 - mask)
        aux = torch.zeros((), dtype=scores.dtype, device=scores.device)
        return (torch.stack(idxs, -1), torch.stack(slots, -1),
                torch.stack(ws, -1), torch.stack(keeps, -1), aux)


class SwitchGate(BaseGate):
    """Top-1 routing with the load-balance aux loss (reference
    ``SwitchGate``)."""

    top_k = 1

    def __init__(self, d_model, num_experts, capacity_factor: float = 1.25,
                 **kw):
        super().__init__(d_model, num_experts, **kw)
        self.capacity_factor = capacity_factor

    def route_indices(self, scores, capacity, valid=None):
        n, e = scores.shape
        probs = _softmax(scores)
        idx = probs.argmax(dim=-1)
        mask = _one_hot(idx, e, scores.dtype)
        if valid is not None:
            mask = mask * valid.to(scores.dtype)[:, None]
        aux = (probs.mean(dim=0) * mask.mean(dim=0)).sum() * e
        my_pos = _pick(_positions_in_expert(mask) * mask, idx)
        keep = my_pos < capacity
        if valid is not None:
            keep = keep & valid
        w = (probs * mask).sum(-1) * keep.to(scores.dtype)
        return (idx.to(torch.int32)[:, None], my_pos.to(torch.int32)[:, None],
                w[:, None], keep[:, None], aux)


class GShardGate(BaseGate):
    """Top-2 routing with capacity and the aux loss (reference
    ``GShardGate``): both kept weights renormalised, the deterministic
    variant of the paper's random second-expert drop."""

    top_k = 2

    def __init__(self, d_model, num_experts, capacity_factor: float = 2.0,
                 **kw):
        super().__init__(d_model, num_experts, **kw)
        self.capacity_factor = capacity_factor

    def route_indices(self, scores, capacity, valid=None):
        n, e = scores.shape
        vf = None if valid is None else valid.to(scores.dtype)[:, None]
        probs = _softmax(scores)
        idx1 = probs.argmax(dim=-1)
        mask1 = _one_hot(idx1, e, scores.dtype)
        if vf is not None:
            mask1 = mask1 * vf
        idx2 = (probs * (1.0 - mask1)).argmax(dim=-1)
        mask2 = _one_hot(idx2, e, scores.dtype)
        if vf is not None:
            mask2 = mask2 * vf
        aux = (probs.mean(dim=0) * mask1.mean(dim=0)).sum() * e
        pos1 = _positions_in_expert(mask1) * mask1
        count1 = mask1.sum(dim=0, keepdim=True)
        pos2 = (_positions_in_expert(mask2) + count1) * mask2
        my_pos1, my_pos2 = _pick(pos1, idx1), _pick(pos2, idx2)
        keep1, keep2 = my_pos1 < capacity, my_pos2 < capacity
        if valid is not None:
            keep1, keep2 = keep1 & valid, keep2 & valid
        w1 = (probs * mask1).sum(-1)
        w2 = (probs * mask2).sum(-1)
        denom = (w1 * keep1 + w2 * keep2).clamp(min=1e-9)
        w1 = w1 * keep1 / denom
        w2 = w2 * keep2 / denom
        e_idx = torch.stack([idx1, idx2], -1).to(torch.int32)
        slot = torch.stack([my_pos1, my_pos2], -1).to(torch.int32)
        return (e_idx, slot, torch.stack([w1, w2], -1),
                torch.stack([keep1, keep2], -1), aux)
