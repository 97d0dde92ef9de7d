"""The optimizers (port of ``paddle_tpu/optimizer/optimizers.py``): SGD,
Momentum, Adagrad, Adadelta, Adam, AdamW, Adamax, Lamb, RMSProp, Rprop,
ASGD, NAdam and RAdam.

Each ``_apply_one`` is the reference's update chain in plain elementwise
torch, as the reference leaves its chain to XLA. It rounds where the
reference rounds. With a master weight the chain runs in fp32 from the
master and the parameter takes the result cast to its dtype. Without one
it runs in the parameter's dtype: the gradient is cast to it, and the
fp32 scalars of the step (``1 - beta**t``, the learning rate) are cast to
it before they meet a tensor, as ``.astype(wv.dtype)`` does there. The
update reads the learning rate and the step count from their device
tensors and branches on no device value (RAdam's rectification is a
``torch.where``), so a step makes no host sync. Accumulator names are the
reference's: they are the state-dict keys.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adagrad", "Adadelta", "Adam", "AdamW",
           "Adamax", "Lamb", "RMSProp", "Rprop", "ASGD", "NAdam", "RAdam"]


def _bc(beta: float, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(1 - beta ** t)`` in fp32, cast to ``dtype``."""
    return (1 - torch.pow(beta, t)).to(dtype)


class SGD(Optimizer):
    _ACC_NAMES = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _apply_one(self, p, g):
        decay = self._decayed_grad_fn("l2")
        master = self._master(p)
        if master is not None:
            new = master - self._lr_tensor * decay(master, g.float())
        else:
            # the reference does not cast the gradient here: an fp32
            # gradient on a bf16 weight promotes the chain to fp32
            new = p - self._lr(p.dtype) * decay(p, g)
        self._write(p, master, new)


class Momentum(Optimizer):
    _ACC_NAMES = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _apply_one(self, p, g):
        decay = self._decayed_grad_fn("l2")
        mu = self._momentum
        vel = self._acc("velocity", p)
        w, master = self._weights(p)
        grad = decay(w, g.to(w.dtype))
        v_new = mu * vel + grad
        upd = grad + mu * v_new if self._nesterov else v_new
        vel.copy_(v_new)
        self._write(p, master, w - self._lr(w.dtype) * upd)


class Adagrad(Optimizer):
    _ACC_NAMES = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _apply_one(self, p, g):
        decay = self._decayed_grad_fn("l2")
        moment = self._acc("moment", p, fill=self._init_acc)
        w, master = self._weights(p)
        grad = decay(w, g.to(w.dtype))
        m_new = moment + grad * grad
        moment.copy_(m_new)
        self._write(p, master, w - self._lr(w.dtype) * grad
                    / (torch.sqrt(m_new) + self._epsilon))


class Adadelta(Optimizer):
    _ACC_NAMES = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon, self._rho = epsilon, rho

    def _apply_one(self, p, g):
        decay = self._decayed_grad_fn("l2")
        eps, rho = self._epsilon, self._rho
        avg_sq = self._acc("avg_squared_grad", p)
        avg_upd = self._acc("avg_squared_update", p)
        w, master = self._weights(p)
        grad = decay(w, g.to(w.dtype))
        asq_new = rho * avg_sq + (1 - rho) * grad * grad
        upd = torch.sqrt(avg_upd + eps) / torch.sqrt(asq_new + eps) * grad
        aup_new = rho * avg_upd + (1 - rho) * upd * upd
        avg_sq.copy_(asq_new)
        avg_upd.copy_(aup_new)
        self._write(p, master, w - self._lr(w.dtype) * upd)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None,
                 decoupled=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        self._decoupled = decoupled

    @property
    def _ACC_NAMES(self):
        return ("moment1", "moment2") + (
            ("moment2_max",) if self._amsgrad else ())

    def _wd_coeff(self) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if isinstance(wd, (int, float)):
            return float(wd)
        return float(getattr(wd, "_coeff", getattr(wd, "coeff", 0.0)))

    def _apply_one(self, p, g, wd=None, lr_scale=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd = self._wd_coeff() if wd is None else wd
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        w, master = self._weights(p)
        dt = w.dtype
        grad = g.to(dt)
        if wd and not self._decoupled:
            grad = grad + wd * w
        t = self._t()
        m_new = b1 * m + (1 - b1) * grad
        v_new = b2 * v + (1 - b2) * grad * grad
        m_hat = m_new / _bc(b1, t, dt)
        if self._amsgrad:
            vmax = self._acc("moment2_max", p)
            v_use = torch.maximum(vmax, v_new)
            vmax.copy_(v_use)
        else:
            v_use = v_new
        upd = m_hat / (torch.sqrt(v_use / _bc(b2, t, dt)) + eps)
        if wd and self._decoupled:
            upd = upd + wd * w
        lr = self._lr_tensor if lr_scale is None \
            else self._lr_tensor * lr_scale
        m.copy_(m_new)
        v.copy_(v_new)
        self._write(p, master, w - lr.to(dt) * upd)


class Adam(_AdamBase):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor, amsgrad, name, decoupled=False)


class AdamW(_AdamBase):
    """Decoupled weight decay (reference ``optimizer/adamw.py``).

    ``apply_decay_param_fun(name)`` gets the parameter's ``name`` attribute
    (None for a model's parameters, as in the reference) and turns decay
    off where it returns False. ``lr_ratio(p)`` scales the learning rate
    of ``p``, as Paddle's AdamW does; the JAX package accepts it and leaves
    it unused (ROADMAP.md C)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         False, amsgrad, name, decoupled=True)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _apply_one(self, p, g):
        wd = None
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(getattr(p, "name", None)):
            wd = 0.0
        ratio = None if self._lr_ratio is None else float(self._lr_ratio(p))
        super()._apply_one(p, g, wd=wd,
                           lr_scale=None if ratio == 1.0 else ratio)


class Adamax(Optimizer):
    _ACC_NAMES = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _apply_one(self, p, g):
        decay = self._decayed_grad_fn("l2")
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = self._acc("moment", p)
        inf_norm = self._acc("inf_norm", p)
        w, master = self._weights(p)
        grad = decay(w, g.to(w.dtype))
        m_new = b1 * m + (1 - b1) * grad
        u_new = torch.maximum(b2 * inf_norm, grad.abs())
        lr_t = (self._lr_tensor / (1 - torch.pow(b1, self._t()))).to(w.dtype)
        m.copy_(m_new)
        inf_norm.copy_(u_new)
        self._write(p, master, w - lr_t * m_new / (u_new + eps))


class Lamb(Optimizer):
    _ACC_NAMES = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_one(self, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) \
            else self._wd
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        w, master = self._weights(p)
        dt = w.dtype
        grad = g.to(dt)
        t = self._t()
        m_new = b1 * m + (1 - b1) * grad
        v_new = b2 * v + (1 - b2) * grad * grad
        m_hat = m_new / _bc(b1, t, dt)
        v_hat = v_new / _bc(b2, t, dt)
        r = m_hat / (torch.sqrt(v_hat) + eps) + wd * w
        # both norms in the weight's dtype, as jnp.linalg.norm gives them
        w_norm = torch.linalg.vector_norm(w)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), dtype=dt, device=w.device))
        m.copy_(m_new)
        v.copy_(v_new)
        self._write(p, master, w - self._lr(dt) * trust * r)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    @property
    def _ACC_NAMES(self):
        return ("mean_square", "momentum") + (
            ("mean_grad",) if self._centered else ())

    def _apply_one(self, p, g):
        decay = self._decayed_grad_fn("l2")
        rho, eps, mu = self._rho, self._epsilon, self._momentum
        ms = self._acc("mean_square", p)
        mom = self._acc("momentum", p)
        w, master = self._weights(p)
        grad = decay(w, g.to(w.dtype))
        ms_new = rho * ms + (1 - rho) * grad * grad
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg_new = rho * mg + (1 - rho) * grad
            denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
            mg.copy_(mg_new)
        else:
            denom = torch.sqrt(ms_new + eps)
        mom_new = mu * mom + self._lr(w.dtype) * grad / denom
        ms.copy_(ms_new)
        mom.copy_(mom_new)
        self._write(p, master, w - mom_new)


class Rprop(Optimizer):
    _ACC_NAMES = ("prev_grad", "step_sizes")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _apply_one(self, p, g):
        lo, hi = self._lr_range
        eta_n, eta_p = self._etas
        prev = self._acc("prev_grad", p)
        sizes = self._accumulators.get("step_sizes", {}).get(id(p))
        if sizes is None:
            # the step sizes start at the learning rate: the reference
            # reads it to the host here, at first use only
            sizes = self._acc("step_sizes", p, fill=float(self._lr_tensor))
        w, master = self._weights(p)
        grad = g.to(w.dtype)
        sign = torch.sign(grad * prev)
        sz_new = torch.where(sign > 0, sizes * eta_p,
                             torch.where(sign < 0, sizes * eta_n, sizes))
        sz_new = sz_new.clamp(lo, hi)
        grad_eff = grad.masked_fill(sign < 0, 0.0)
        prev.copy_(grad_eff)
        sizes.copy_(sz_new)
        self._write(p, master, w - torch.sign(grad_eff) * sz_new)


class ASGD(Optimizer):
    _ACC_NAMES = ("d", "ys")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._batch_num = batch_num

    def _apply_one(self, p, g):
        decay = self._decayed_grad_fn("l2")
        d = self._acc("d", p)
        ys = self._acc("ys", p)
        w, master = self._weights(p)
        grad = decay(w, g.to(w.dtype))
        d_new = d - ys + grad
        d.copy_(d_new)
        ys.copy_(grad)
        self._write(p, master,
                    w - self._lr(w.dtype) / self._batch_num * d_new)


class NAdam(_AdamBase):
    _ACC_NAMES = ("moment1", "moment2")

    def _apply_one(self, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        w, master = self._weights(p)
        dt = w.dtype
        grad = g.to(dt)
        t = self._t()
        m_new = b1 * m + (1 - b1) * grad
        v_new = b2 * v + (1 - b2) * grad * grad
        m_hat = (b1 * m_new / _bc(b1, t + 1, dt)
                 + (1 - b1) * grad / _bc(b1, t, dt))
        v_hat = v_new / _bc(b2, t, dt)
        m.copy_(m_new)
        v.copy_(v_new)
        self._write(p, master, w - self._lr(dt) * m_hat
                    / (torch.sqrt(v_hat) + eps))


class RAdam(_AdamBase):
    _ACC_NAMES = ("moment1", "moment2")

    def _apply_one(self, p, g):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        w, master = self._weights(p)
        dt = w.dtype
        rho_inf = 2.0 / (1 - b2) - 1
        grad = g.to(dt)
        t = self._t()
        m_new = b1 * m + (1 - b1) * grad
        v_new = b2 * v + (1 - b2) * grad * grad
        m_hat = m_new / _bc(b1, t, dt)
        b2t = torch.pow(b2, t)
        rho_t = rho_inf - 2 * t * b2t / (1 - b2t)
        # both branches on the device; where() picks (NaN in r where
        # rho_t <= 5 is not selected)
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                       / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
        v_hat = torch.sqrt(v_new / _bc(b2, t, dt))
        rect = r.to(dt) * m_hat / (v_hat + eps)
        upd = torch.where(rho_t > 5, rect, m_hat)
        m.copy_(m_new)
        v.copy_(v_new)
        self._write(p, master, w - self._lr(dt) * upd)
