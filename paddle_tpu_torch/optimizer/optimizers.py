"""AdamW (port of ``paddle_tpu/optimizer/optimizers.py:148-253``).

Decoupled weight decay, moments in the parameter's dtype
(``multi_precision=False``: bf16 moments for bf16 weights, fp32 for the
fp32 norm weights), rounding where the reference rounds: the gradient is
cast to the weight's dtype, the bias corrections ``1 - beta**t`` are
fp32 and cast to the weight's dtype, as is the learning rate, and then
``w - lr * (m_hat / (sqrt(v_hat) + eps) + wd * w)``. Plain elementwise
torch, as the reference leaves the update to XLA.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["AdamW"]


class AdamW(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay: float = 0.01,
                 grad_clip=None, multi_precision: bool = False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _apply_one(self, p: torch.nn.Parameter, g: torch.Tensor) -> None:
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd = float(self._weight_decay or 0.0)
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        dt = p.dtype
        grad = g.to(dt)
        t = self._step_count.float()
        m_new = b1 * m + (1 - b1) * grad
        v_new = b2 * v + (1 - b2) * grad * grad
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        m_hat = m_new / bc1.to(dt)
        denom = torch.sqrt(v_new / bc2.to(dt)) + eps
        upd = m_hat / denom
        if wd:
            upd = upd + wd * p
        p.copy_(p - self._lr_tensor.to(dt) * upd)
        m.copy_(m_new)
        v.copy_(v_new)
