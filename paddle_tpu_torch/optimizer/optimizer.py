"""Optimizer base class (port of ``paddle_tpu/optimizer/optimizer.py``).

The learning rate and the step count live in device tensors, as the
reference keeps them in persistable tensors, so a captured step reads
them as inputs: a bound ``LRScheduler`` writes its value into the LR
tensor with ``fill_`` and nothing on the update path reads it back to the
host. ``step()`` clips the ``(parameter, gradient)`` list with
``grad_clip``, then updates every parameter that has a gradient in place,
under ``torch.no_grad()``; ``clear_grad()`` sets each gradient to ``None``
(``framework/tensor.py:238``).

Accumulators (Adam's moments, ...) and ``multi_precision`` master weights
are made at first use: a master is an fp32 copy of a bf16/fp16 parameter,
and a parameter with a master keeps its accumulators fp32 too; every other
parameter keeps them in its own dtype. ``state_dict()`` uses the
reference's keys (``param_{i}_{accumulator}``, ``master_weights.param_{i}``,
``global_step``, ``LR_Scheduler``; a parameter with a ``name`` attribute
uses that name in place of ``param_{i}``), and ``set_state_dict`` keeps
what it cannot place yet for the first ``_acc``/``_master`` call that
makes it.

Inside a step captured by ``jit.to_static``, ``step()`` reports its state
tensors to the capture (their storage is guarded) and ``set_lr`` stages
its fill, as the scheduler's is staged.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from paddle_tpu_torch.jit import api as _jit

__all__ = ["Optimizer"]

_HALF = (torch.bfloat16, torch.float16)


def _assign(t: torch.Tensor, value) -> None:
    """``t``'s value from a tensor, array or number, cast and reshaped to
    ``t`` (the reference's ``Tensor.set_value``)."""
    src = torch.as_tensor(value)
    t.copy_(src.reshape(t.shape).to(device=t.device, dtype=t.dtype))


class Optimizer:
    _ACC_NAMES = ()     # the accumulators a subclass keeps (state keys)

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = False, name=None):
        from paddle_tpu_torch.optimizer import lr as lr_mod
        if parameters is None:
            raise ValueError("parameters is required (the port has no "
                             "static mode)")
        self._parameter_list: List[torch.nn.Parameter] = list(parameters)
        if not self._parameter_list:
            raise ValueError("the optimizer got an empty parameter list")
        self._index = {id(p): i for i, p in enumerate(self._parameter_list)}
        dev = self._parameter_list[0].device
        self._lr_scheduler = None
        if isinstance(learning_rate, lr_mod.LRScheduler):
            self._lr_scheduler = learning_rate
            lr0 = float(learning_rate())
        elif isinstance(learning_rate, (int, float)):
            lr0 = float(learning_rate)
        else:
            raise TypeError("learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate).__name__}")
        self._lr_tensor = torch.tensor(lr0, dtype=torch.float32, device=dev)
        if self._lr_scheduler is not None:
            self._lr_scheduler._bind_tensor(self._lr_tensor)
        self._step_count = torch.zeros((), dtype=torch.int32, device=dev)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._use_master_weights = bool(multi_precision)
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._master_weights: Dict[int, torch.Tensor] = {}
        # state loaded before its accumulator or master exists: _acc and
        # _master consume it at first use
        self._pending_state: Dict = {}

    # -- state access ---------------------------------------------------------
    def _trainable_parameters(self) -> List[torch.nn.Parameter]:
        return [p for p in self._parameter_list if p.requires_grad]

    def _param_key(self, p: torch.Tensor) -> str:
        name = getattr(p, "name", None)
        if name:
            return name
        i = self._index.get(id(p))
        return f"param_{i}" if i is not None else str(id(p))

    def _use_master(self, p: torch.Tensor) -> bool:
        return self._use_master_weights and p.dtype in _HALF

    def _acc_dtype(self, p: torch.Tensor) -> torch.dtype:
        return torch.float32 if self._use_master(p) else p.dtype

    def _acc(self, name: str, p: torch.Tensor,
             fill: Optional[float] = None) -> torch.Tensor:
        """The accumulator ``name`` of ``p``: at first use, ``fill`` (0 if
        None) in fp32 when ``p`` has a master weight, else in ``p``'s
        dtype, or the loaded state waiting for it."""
        store = self._accumulators.setdefault(name, {})
        t = store.get(id(p))
        if t is None:
            t = torch.full(p.shape, 0.0 if fill is None else float(fill),
                           dtype=self._acc_dtype(p), device=p.device)
            store[id(p)] = t
            key = f"{self._param_key(p)}_{name}"
            if key in self._pending_state:
                _assign(t, self._pending_state.pop(key))
        return t

    def _master(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        """``p``'s fp32 master weight (made from ``p`` at first use), or
        None when ``p`` has none."""
        if not self._use_master(p):
            return None
        m = self._master_weights.get(id(p))
        if m is None:
            m = self._master_weights[id(p)] = p.detach().float().clone(
                memory_format=torch.contiguous_format)
            key = f"master_weights.{self._param_key(p)}"
            if key in self._pending_state:
                _assign(m, self._pending_state.pop(key))
        return m

    def _weights(self, p: torch.Tensor):
        """``(w, master)``: the tensor the update reads (the master where
        there is one) and the master or None."""
        master = self._master(p)
        return (p if master is None else master), master

    @staticmethod
    def _write(p: torch.Tensor, master: Optional[torch.Tensor],
               new: torch.Tensor) -> None:
        """Store an update: into the master and, rounded, into ``p``."""
        if master is not None:
            master.copy_(new)
        p.copy_(new)

    def _lr(self, dtype: torch.dtype) -> torch.Tensor:
        """The device LR as a 0-d tensor of ``dtype`` (no host read)."""
        return self._lr_tensor.to(dtype)

    def _t(self) -> torch.Tensor:
        """The step count as a 0-d fp32 device tensor."""
        return self._step_count.float()

    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._lr_tensor)

    def set_lr(self, value: float) -> None:
        value = float(value)
        _jit.staged_fill(self._lr_tensor, lambda: value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._lr_scheduler = scheduler
        scheduler._bind_tensor(self._lr_tensor)

    # -- the step -------------------------------------------------------------
    def step(self) -> None:
        self._step_pairs([(p, p.grad) for p in self._trainable_parameters()
                          if p.grad is not None])

    @torch.no_grad()
    def _step_pairs(self, params_grads) -> None:
        """One step over ``(parameter, gradient)`` pairs: clip, count,
        update."""
        _jit.note_state(self._state_tensors)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        for p, g in params_grads:
            if g is not None:
                self._apply_one(p, g)

    def _apply_one(self, p: torch.nn.Parameter, g: torch.Tensor) -> None:
        raise NotImplementedError

    def _state_tensors(self) -> List[torch.Tensor]:
        """The device state a step reads and writes in place."""
        out = [self._lr_tensor, self._step_count]
        for store in self._accumulators.values():
            out.extend(store.values())
        out.extend(self._master_weights.values())
        return out

    def _decayed_grad_fn(self, wd_mode: str):
        """L2 regularization folded into the gradient (coupled mode)."""
        wd = self._weight_decay
        if wd is None or wd_mode == "decoupled":
            return lambda param, grad: grad
        coeff = float(wd) if isinstance(wd, (int, float)) else float(
            getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))
        return lambda param, grad: grad + coeff * param

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every gradient. ``set_to_zero`` is accepted and, as in the
        reference, drops them too."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # -- (de)serialization ----------------------------------------------------
    def _key_of(self, pid: int) -> str:
        p = self._parameter_list[self._index[pid]] if pid in self._index \
            else None
        return self._param_key(p) if p is not None else str(pid)

    def state_dict(self) -> Dict:
        """The live state tensors under the reference's keys (clone them to
        keep a snapshot)."""
        state = OrderedDict()
        for acc_name, store in self._accumulators.items():
            for pid, t in store.items():
                state[f"{self._key_of(pid)}_{acc_name}"] = t
        for pid, t in self._master_weights.items():
            state[f"master_weights.{self._key_of(pid)}"] = t
        state["global_step"] = self._step_count
        if self._lr_scheduler is not None:
            state["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return state

    def set_state_dict(self, state: Dict) -> None:
        state = dict(state)
        for acc_name, store in self._accumulators.items():
            for pid, t in store.items():
                key = f"{self._key_of(pid)}_{acc_name}"
                if key in state:
                    _assign(t, state.pop(key))
        for pid, t in self._master_weights.items():
            key = f"master_weights.{self._key_of(pid)}"
            if key in state:
                _assign(t, state.pop(key))
        if "global_step" in state:
            _assign(self._step_count, state.pop("global_step"))
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state.pop("LR_Scheduler"))
        self._pending_state.update(state)
