"""Gradient accumulation ("gradient merge") with master gradients, as a
wrapper optimizer (port of ``paddle_tpu/optimizer/gradient_merge.py``).

Each ``step()`` adds every present gradient (times ``1/k`` with ``avg``)
into a buffer beside its parameter, fp32 with ``master_grad`` and in the
gradient's parameter's dtype otherwise; every ``k``-th call hands the
merged gradients to the inner optimizer, which updates, and drains the
buffers. A parameter updates on that call only if it took a gradient in
some micro-step of the window (its touched flag): one whose buffer exists
but which got no gradient in the window keeps its weights, moments and
masters, as the reference's per-parameter mask keeps them.

The reference runs the inner step on every call and masks its outcome
with ``jnp.where``, so that a traced step stays one program. The port
keeps the window's count as a host integer and runs the inner step only
on the apply call, which gives the same state. Under ``jit.to_static``
the branch is a host guard (whether this call applies, and on an apply
call which parameters the window touched), so a step captures as two
programs, the accumulating one and the applying one, and the count and
touched flags are host effects that run again before every replay. The
state dict carries the count as a tensor under the reference's key, with
``gm_buffer.{param}`` and ``gm_touched.{param}``.
"""

from __future__ import annotations

from typing import Dict

import torch

from paddle_tpu_torch.jit import api as _jit
from paddle_tpu_torch.optimizer.optimizer import _assign

__all__ = ["GradientMergeOptimizer"]


class GradientMergeOptimizer:
    """Wrap ``inner`` so gradients accumulate for ``k_steps`` calls and
    the update happens on every ``k``-th ``step()``. ``avg=True`` averages
    the micro-steps' gradients; ``master_grad`` keeps the buffers fp32
    (with ``k_steps=1`` that is the master-grad pass: fp32 gradients into
    the clip and the update)."""

    def __init__(self, inner, k_steps: int = 1, avg: bool = True,
                 master_grad: bool = True):
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._inner = inner
        self._k = int(k_steps)
        self._avg = bool(avg)
        self._master_grad = bool(master_grad)
        self._buffers: Dict[int, torch.Tensor] = {}
        self._touched: Dict[int, bool] = {}
        self._count = 0

    def _buffer(self, p: torch.Tensor) -> torch.Tensor:
        buf = self._buffers.get(id(p))
        if buf is None:
            pending = self._inner._pending_state
            key = self._inner._param_key(p)
            buf = self._buffers[id(p)] = torch.zeros(
                p.shape, device=p.device,
                dtype=torch.float32 if self._master_grad else p.dtype)
            self._touched[id(p)] = False
            if f"gm_buffer.{key}" in pending:
                _assign(buf, pending.pop(f"gm_buffer.{key}"))
            if f"gm_touched.{key}" in pending:
                self._touched[id(p)] = bool(pending.pop(f"gm_touched.{key}"))
        return buf

    def _window(self):
        """The host branch of this call: whether it applies and, if it
        does, the parameters touched earlier in the window."""
        if (self._count + 1) % self._k:
            return (False,)
        return (True, tuple(sorted(k for k, v in self._touched.items()
                                   if v)))

    def _host_state(self):
        return self._count, dict(self._touched)

    def _set_host_state(self, state) -> None:
        self._count, touched = state
        self._touched.clear()
        self._touched.update(touched)

    def _advance(self, touched, reset) -> None:
        for i in touched:
            self._touched[i] = True
        self._count += 1
        for i in reset:
            self._touched[i] = False

    def _state_tensors(self):
        return list(self._buffers.values()) + self._inner._state_tensors()

    @torch.no_grad()
    def step(self) -> None:
        inner = self._inner
        _jit.host_guard(self._window)
        _jit.note_state(self._state_tensors)
        apply = self._window()[0]
        scale = (1.0 / self._k) if self._avg else 1.0
        params = [p for p in inner._trainable_parameters()
                  if p.grad is not None or id(p) in self._buffers]
        touched = []
        for p in params:
            buf = self._buffer(p)
            if p.grad is not None:
                buf.copy_(buf + p.grad.to(buf.dtype) * scale)
                touched.append(id(p))
        if not apply:
            _jit.host_effect(lambda: self._advance(touched, ()), owner=self)
            return
        # the merged gradients go to the inner step as its pairs: an fp32
        # buffer cannot stand in a bf16 parameter's .grad
        now = set(touched)
        inner._step_pairs([(p, self._buffers[id(p)]) for p in params
                           if self._touched[id(p)] or id(p) in now])
        for p in params:
            self._buffers[id(p)].zero_()
        reset = [id(p) for p in params]
        _jit.host_effect(lambda: self._advance(touched, reset), owner=self)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self, set_to_zero: bool = False) -> None:
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    # -- (de)serialization --------------------------------------------------
    def state_dict(self) -> Dict:
        state = dict(self._inner.state_dict())
        state["gradient_merge.count"] = torch.tensor(self._count,
                                                     dtype=torch.int32)
        for p in self._inner._parameter_list:
            if id(p) in self._buffers:
                key = self._inner._param_key(p)
                state[f"gm_buffer.{key}"] = self._buffers[id(p)]
                state[f"gm_touched.{key}"] = torch.tensor(
                    self._touched[id(p)])
        return state

    def set_state_dict(self, state: Dict) -> None:
        state = dict(state)
        if "gradient_merge.count" in state:
            self._count = int(state.pop("gradient_merge.count"))
        for p in self._inner._parameter_list:
            key = self._inner._param_key(p)
            if f"gm_buffer.{key}" in state and id(p) in self._buffers:
                _assign(self._buffers[id(p)], state.pop(f"gm_buffer.{key}"))
            if f"gm_touched.{key}" in state and id(p) in self._touched:
                self._touched[id(p)] = bool(state.pop(f"gm_touched.{key}"))
        # what is left waits in the inner optimizer's pending state
        self._inner.set_state_dict(state)

    # everything else (LR control, parameter list, accumulators) is the
    # inner optimizer's
    def __getattr__(self, name):
        return getattr(self._inner, name)
