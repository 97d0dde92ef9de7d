"""Optimizer base class (port of ``paddle_tpu/optimizer/optimizer.py``).

The learning rate and the step count live in device tensors, as the
reference keeps them in persistable tensors, so a captured step reads
them as inputs. ``step()`` updates every parameter that has a gradient in
place, under ``torch.no_grad()``; ``clear_grad()`` sets each gradient to
``None`` (``framework/tensor.py:238``). Accumulators (Adam's moments) are
made at the first step, in the parameter's dtype.

Not ported yet (ROADMAP.md A.3): gradient clipping, ``multi_precision``
master weights, learning-rate schedulers and optimizer state dicts.
"""

from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate: float = 0.001, parameters=None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = False):
        if parameters is None:
            raise ValueError("parameters is required (the port has no "
                             "static mode)")
        for option, value in (("grad_clip", grad_clip),
                              ("multi_precision", multi_precision)):
            if value:
                raise NotImplementedError(
                    f"Optimizer {option} is not ported yet (ROADMAP.md A.3)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("learning-rate schedulers are not "
                                      "ported yet (ROADMAP.md A.3)")
        self._parameter_list: List[torch.nn.Parameter] = list(parameters)
        if not self._parameter_list:
            raise ValueError("the optimizer got an empty parameter list")
        dev = self._parameter_list[0].device
        self._lr_tensor = torch.tensor(float(learning_rate),
                                       dtype=torch.float32, device=dev)
        self._step_count = torch.zeros((), dtype=torch.int32, device=dev)
        self._weight_decay = weight_decay
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}

    def _trainable_parameters(self) -> List[torch.nn.Parameter]:
        return [p for p in self._parameter_list if p.requires_grad]

    def _acc(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """The accumulator ``name`` of ``p``: zeros in p's dtype at first
        use."""
        store = self._accumulators.setdefault(name, {})
        t = store.get(id(p))
        if t is None:
            t = store[id(p)] = torch.zeros_like(p,
                                                memory_format=torch.contiguous_format)
        return t

    @torch.no_grad()
    def step(self) -> None:
        self._step_count += 1
        for p in self._trainable_parameters():
            if p.grad is not None:
                self._apply_one(p, p.grad)

    def _apply_one(self, p: torch.nn.Parameter, g: torch.Tensor) -> None:
        raise NotImplementedError

    def clear_grad(self) -> None:
        for p in self._parameter_list:
            p.grad = None
