"""LR schedulers (port of ``paddle_tpu/optimizer/lr.py``): the 17
schedulers of the reference over an ``LRScheduler`` base.

A scheduler's values are Python floats, computed on the host by the
reference's expressions. An optimizer binds its device LR tensor to its
scheduler, and each ``step()`` writes the new value into that tensor with
``fill_``: the update reads the LR from the device and nothing reads it
back to the host. Inside a step captured by ``jit.to_static`` the epoch
arithmetic is a host effect, run again before every replay, and the fill
is staged (:func:`paddle_tpu_torch.jit.api.staged_fill`), so each replay
reads its own step's LR.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional

from paddle_tpu_torch.jit import api as _jit

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay", "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
    "CosineAnnealingWarmRestarts", "LinearLR",
]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self._bound_tensor = None
        self.step()

    def _bind_tensor(self, tensor) -> None:
        self._bound_tensor = tensor
        self._push()

    def _push(self) -> None:
        if self._bound_tensor is not None:
            _jit.staged_fill(self._bound_tensor, lambda: float(self.last_lr))

    def __call__(self) -> float:
        return self.last_lr

    def step(self, epoch: Optional[int] = None) -> None:
        _jit.host_effect(lambda: self._advance(epoch), owner=self)
        self._push()

    def _advance(self, epoch: Optional[int]) -> None:
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    # the host state a dropped capture restores
    def _host_state(self) -> dict:
        return copy.deepcopy(self.state_dict())

    def _set_host_state(self, state: dict) -> None:
        self.set_state_dict(state)

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_bound_tensor",)
                and isinstance(v, (int, float, bool, str, list, tuple,
                                   type(None)))}

    def set_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)
        self._push()

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5
                * min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: List[int], values: List[float],
                 last_epoch=-1, verbose=False):
        self.boundaries, self.values = list(boundaries), list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr, self.power, self.cycle = end_lr, power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(max(step, 1) / self.decay_steps)
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class LinearWarmup(LRScheduler):
    """``start_lr`` to ``end_lr`` over ``warmup_steps``, then the inner
    scheduler (stepped ``warmup_steps`` behind) or the constant
    ``learning_rate``. The state dict nests the inner one's."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.inner = learning_rate if isinstance(learning_rate, LRScheduler) \
            else None
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr
        base = learning_rate.base_lr if self.inner else learning_rate
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if self.inner is not None:
            self.inner.step(self.last_epoch - self.warmup_steps)
            return self.inner.last_lr
        return self.base_lr

    def state_dict(self):
        d = super().state_dict()
        if self.inner is not None:
            d["inner"] = self.inner.state_dict()
        return d

    def set_state_dict(self, state):
        state = dict(state)
        inner = state.pop("inner", None)
        super().set_state_dict(state)
        if inner and self.inner is not None:
            self.inner.set_state_dict(inner)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch
                                             // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        self._factor = 1.0
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._factor *= self.lr_lambda(self.last_epoch)
        return self.base_lr * self._factor

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr,
                "_factor": self._factor}


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0,
                 last_epoch=-1, verbose=False):
        self.T_0, self.T_mult, self.eta_min = T_0, T_mult, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = max(self.last_epoch, 0)
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * t / t_i)) / 2)


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1. / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor, self.end_factor = start_factor, end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        factor = self.start_factor + (
            self.end_factor - self.start_factor) * t / self.total_steps
        return self.base_lr * factor


class ReduceOnPlateau(LRScheduler):
    """Scales the LR by ``factor`` after ``patience`` steps without
    improvement. ``step(metrics)`` reads the metric to the host (a tensor
    through ``.item()``), as the reference's does; ``step()`` without one
    leaves the LR."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return getattr(self, "last_lr", self.base_lr)

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            if not hasattr(self, "last_lr"):
                self.last_lr = self.base_lr
                self._push()
            return
        _jit.uncapturable("ReduceOnPlateau.step(metrics) (the metric is "
                          "read on the host)")
        value = float(metrics.item()) if hasattr(metrics, "item") \
            else float(metrics)
        if self.best is None:
            self.best = value
        else:
            improved = (value < self.best - self._thr()) \
                if self.mode == "min" else (value > self.best + self._thr())
            if improved:
                self.best = value
                self.num_bad = 0
            elif self.cooldown_counter > 0:
                self.cooldown_counter -= 1
            else:
                self.num_bad += 1
                if self.num_bad > self.patience:
                    new_lr = max(self.last_lr * self.factor, self.min_lr)
                    if self.last_lr - new_lr > self.epsilon:
                        self.last_lr = new_lr
                    self.cooldown_counter = self.cooldown
                    self.num_bad = 0
        self._push()

    def _thr(self):
        if self.threshold_mode == "rel":
            return abs(self.best) * self.threshold if self.best else 0.0
        return self.threshold


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return start + (end - start) * pct

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        up_steps = int(self.phase_pct * self.total_steps)
        if t <= up_steps and up_steps > 0:
            return self._interp(self.initial_lr, self.max_lr, t / up_steps)
        down = self.total_steps - up_steps
        pct = (t - up_steps) / max(down, 1)
        return self._interp(self.max_lr, self.end_lr, pct)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up=2000, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        pos = x / self.up if x <= self.up else 1 - (x - self.up) / self.down
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp * max(0.0, pos)
