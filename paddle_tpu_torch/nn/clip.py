"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``).

``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` take
an optimizer's ``(parameter, gradient)`` list and return a clipped one;
``clip_grad_norm_`` and ``clip_grad_value_`` clip ``p.grad`` in place.
Everything stays on the gradients' device: a norm and its clip factor are
0-d device tensors, no branch reads them, so a clipped step makes no host
sync. Norms are taken in fp32 whatever the gradient's dtype, as a sum of
squares as the reference takes them (``torch.linalg.vector_norm`` on the
CPU accumulates a long fp32 tensor with a relative error of ~4e-3 at 49M
elements), and a scaled gradient is the fp32 product cast back to its
dtype, as in the reference.
"""

from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    """``sum(g**2)`` in fp32 (0-d, on ``g``'s device)."""
    return g.float().square().sum()


def _scaled(g: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``g * factor`` in fp32, cast to ``g``'s dtype."""
    return (g.float() * factor).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = _sq_sum(g).sqrt()
            factor = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            out.append((p, _scaled(g, factor)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads) -> torch.Tensor:
        """The fp32 L2 norm over every gradient of ``grads`` (0-d)."""
        return torch.stack([_sq_sum(g) for g in grads]).sum().sqrt()

    def _clip(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        norm = self.global_norm(grads)
        factor = (self.clip_norm / norm.clamp_min(self.clip_norm)) \
            .clamp_max(1.0)
        return [(p, g if g is None else _scaled(g, factor))
                for p, g in params_grads]


def _params(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` by ``min(max_norm / total, 1)`` in place and
    return ``total``, the ``norm_type`` norm over all of them (fp32, on
    the device). ``error_if_nonfinite`` is accepted and, as in the
    reference, not checked: checking would read the norm to the host."""
    params = _params(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([
            (g.float().abs() ** norm_type).sum() for g in grads]
        ).sum() ** (1.0 / norm_type)
    factor = (max_norm / total.clamp_min(1e-6)).clamp_max(1.0)
    for g in grads:
        g.copy_(_scaled(g, factor))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in _params(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
