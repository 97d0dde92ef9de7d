"""L-BFGS (port of ``paddle_tpu/optimizer/lbfgs.py``).

A full-batch quasi-Newton optimizer driven by a closure, as the
reference's ``LBFGS.step(closure)``: it keeps ``history_size`` (s, y)
pairs, takes the search direction from the two-loop recursion, and steps
with the learning rate or a strong-Wolfe line search
(``line_search_fn="strong_wolfe"``), re-evaluating the loss through the
closure. The curvature history is flat fp32 vectors on the parameters'
device (all parameters concatenated). Like the reference, its control
flow reads losses and dot products to the host: L-BFGS is not a
pretraining path, and a ``jit.to_static`` step that calls it runs eagerly.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from paddle_tpu_torch.jit import api as _jit
from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["LBFGS"]


class LBFGS(Optimizer):
    _ACC_NAMES = ()

    def __init__(self, learning_rate: float = 1.0, max_iter: int = 20,
                 max_eval: Optional[int] = None,
                 tolerance_grad: float = 1e-07,
                 tolerance_change: float = 1e-09, history_size: int = 100,
                 line_search_fn: Optional[str] = None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or "
                             f"'strong_wolfe', got {line_search_fn!r}")
        self.max_iter = int(max_iter)
        self.max_eval = int(max_eval) if max_eval is not None else \
            self.max_iter * 5 // 4
        self.tolerance_grad = float(tolerance_grad)
        self.tolerance_change = float(tolerance_change)
        self.history_size = int(history_size)
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._rho: List[float] = []
        self._gamma = 1.0
        self._n_evals = 0

    # -- flat-vector <-> parameter views --------------------------------------
    def _params(self):
        return self._trainable_parameters()

    def _gather_flat_grad(self) -> torch.Tensor:
        """The gradients as one flat fp32 vector, through ``grad_clip``
        and (L2) ``weight_decay``; a parameter without one gives zeros."""
        params = self._params()
        clipped = None
        if self._grad_clip is not None:
            pairs = [(p, p.grad) for p in params if p.grad is not None]
            clipped = {id(p): g for p, g in self._grad_clip(pairs)}
        decay = self._decayed_grad_fn("l2")
        grads = []
        for p in params:
            g = p.grad if clipped is None else clipped.get(id(p), p.grad)
            if g is None:
                grads.append(torch.zeros(p.numel(), dtype=torch.float32,
                                         device=p.device))
            else:
                grads.append(decay(p.detach().float(), g.float()).reshape(-1))
        return torch.cat(grads)

    @torch.no_grad()
    def _add_to_params(self, step_size: float, direction: torch.Tensor):
        offset = 0
        for p in self._params():
            n = p.numel()
            upd = direction[offset:offset + n].reshape(p.shape)
            p.copy_((p.float() + step_size * upd).to(p.dtype))
            offset += n

    def _clone_params(self):
        return [p.detach().clone() for p in self._params()]

    @torch.no_grad()
    def _restore_params(self, saved):
        for p, d in zip(self._params(), saved):
            p.copy_(d)

    # -- two-loop recursion ---------------------------------------------------
    def _direction(self, flat_grad: torch.Tensor) -> torch.Tensor:
        q = -flat_grad
        alphas = []
        for s, y, rho in zip(reversed(self._s), reversed(self._y),
                             reversed(self._rho)):
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append(a)
        q = q * self._gamma
        for (s, y, rho), a in zip(zip(self._s, self._y, self._rho),
                                  reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    def _evaluate(self, closure: Callable):
        """Run the closure (it clears the gradients, computes the loss and
        calls backward); ``(loss, flat gradient)``."""
        self._n_evals += 1
        with torch.enable_grad():
            loss = closure()
        if isinstance(loss, torch.Tensor):
            loss = loss.detach()
        return float(loss), self._gather_flat_grad()

    # -- strong Wolfe line search ---------------------------------------------
    def _line_search(self, closure, direction, f0, g0_dot_d, t0):
        """The reference's bracket-and-bisection search for a step that
        meets the strong Wolfe conditions (Nocedal and Wright, algorithms
        3.5 and 3.6)."""
        c1, c2 = 1e-4, 0.9
        max_ls = 25
        saved = self._clone_params()

        def phi(t):
            self._restore_params(saved)
            self._add_to_params(t, direction)
            f, g = self._evaluate(closure)
            return f, float(torch.dot(g, direction)), g

        t_prev, f_prev, gd_prev = 0.0, f0, g0_dot_d
        t = t0
        bracket = None
        f_t = f0
        g_t = None
        for _ in range(max_ls):
            f_t, gd_t, g_t = phi(t)
            if f_t > f0 + c1 * t * g0_dot_d or f_t >= f_prev and t_prev > 0:
                bracket = (t_prev, f_prev, gd_prev, t, f_t, gd_t)
                break
            if abs(gd_t) <= -c2 * g0_dot_d:
                return t, f_t, g_t        # Wolfe satisfied
            if gd_t >= 0:
                bracket = (t, f_t, gd_t, t_prev, f_prev, gd_prev)
                break
            t_prev, f_prev, gd_prev = t, f_t, gd_t
            t = 2.0 * t
        if bracket is None:
            return t, f_t, g_t if g_t is not None else \
                self._gather_flat_grad()
        lo_t, lo_f, lo_gd, hi_t, hi_f, hi_gd = bracket
        for _ in range(max_ls):
            t = 0.5 * (lo_t + hi_t)
            f_t, gd_t, g_t = phi(t)
            if f_t > f0 + c1 * t * g0_dot_d or f_t >= lo_f:
                hi_t, hi_f, hi_gd = t, f_t, gd_t
            else:
                if abs(gd_t) <= -c2 * g0_dot_d:
                    return t, f_t, g_t
                if gd_t * (hi_t - lo_t) >= 0:
                    hi_t, hi_f, hi_gd = lo_t, lo_f, lo_gd
                lo_t, lo_f, lo_gd = t, f_t, gd_t
            if abs(hi_t - lo_t) < self.tolerance_change:
                break
        # no Wolfe point: settle at the best bracketed step and evaluate
        # there, so that loss, gradient and parameters agree
        self._restore_params(saved)
        self._add_to_params(lo_t, direction)
        lo_f, g_lo = self._evaluate(closure)
        return lo_t, lo_f, g_lo

    # -- the step -------------------------------------------------------------
    def step(self, closure: Optional[Callable] = None):
        """Up to ``max_iter`` quasi-Newton iterations driven by
        ``closure``; returns the last loss as an fp32 tensor."""
        if closure is None:
            raise ValueError(
                "LBFGS.step requires a closure that reevaluates the model "
                "and returns the loss (reference optimizer/lbfgs.py)")
        _jit.uncapturable("LBFGS.step (its closure's losses and the line "
                          "search are read on the host)")
        self._n_evals = 0
        loss, flat_grad = self._evaluate(closure)
        lr = self.get_lr()

        for _ in range(self.max_iter):
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            d = self._direction(flat_grad)
            g_dot_d = float(torch.dot(flat_grad, d))
            if g_dot_d > -self.tolerance_change:
                break                      # not a descent direction
            # first iteration: scale to keep the initial step bounded
            t = min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr \
                if not self._s else lr

            prev_grad = flat_grad
            if self.line_search_fn == "strong_wolfe":
                t, loss, flat_grad = self._line_search(
                    closure, d, loss, g_dot_d, t)
                if flat_grad is None:
                    flat_grad = self._gather_flat_grad()
            else:
                self._add_to_params(t, d)
                loss, flat_grad = self._evaluate(closure)

            s = t * d
            y = flat_grad - prev_grad
            ys = float(torch.dot(y, s))
            if ys > 1e-10:
                if len(self._s) >= self.history_size:
                    self._s.pop(0), self._y.pop(0), self._rho.pop(0)
                self._s.append(s)
                self._y.append(y)
                self._rho.append(1.0 / ys)
                self._gamma = ys / float(torch.dot(y, y))
            if float(s.abs().max()) <= self.tolerance_change:
                break
            if self._n_evals >= self.max_eval:
                break
        self._step_count += 1
        return torch.tensor(loss, dtype=torch.float32)

    def state_dict(self):
        state = super().state_dict()
        state["lbfgs_history"] = {
            "s": list(self._s), "y": list(self._y),
            "rho": list(self._rho), "gamma": self._gamma,
        }
        return state

    def set_state_dict(self, state):
        state = dict(state)
        hist = state.pop("lbfgs_history", None)
        if hist is not None:
            dev = self._lr_tensor.device
            self._s = [torch.as_tensor(s, device=dev) for s in hist["s"]]
            self._y = [torch.as_tensor(y, device=dev) for y in hist["y"]]
            self._rho = list(hist["rho"])
            self._gamma = float(hist["gamma"])
        super().set_state_dict(state)
