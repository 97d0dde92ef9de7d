"""The port's LR schedulers against the JAX package's.

Each scheduler, built with the same arguments on both sides, gives the
same learning rate as a Python float, exactly, over 30 steps; its state
dict round-trips into a fresh scheduler that continues the same sequence
(``LinearWarmup`` with its inner scheduler's state nested); and an
optimizer's device LR tensor follows the scheduler bound to it.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import optimizer as pt_optimizer
from paddle_tpu_torch.optimizer import lr as pt_lr

STEPS = 30

# name -> (class, args, kwargs); the lambdas are module-level so that both
# sides call the same function
_LAMBDA = lambda e: 0.95 ** e  # noqa: E731
_MULT = lambda e: 0.9 if e % 3 else 1.05  # noqa: E731
CASES = {
    "noam": ("NoamDecay", (64, 5), dict(learning_rate=2.0)),
    "piecewise": ("PiecewiseDecay", ([4, 9, 17], [0.1, 0.05, 0.01, 0.001]),
                  {}),
    "natural_exp": ("NaturalExpDecay", (0.5, 0.1), {}),
    "inverse_time": ("InverseTimeDecay", (0.5, 0.2), {}),
    "polynomial": ("PolynomialDecay", (0.5, 12),
                   dict(end_lr=0.01, power=2.0)),
    "polynomial_cycle": ("PolynomialDecay", (0.5, 7),
                         dict(end_lr=0.01, power=1.5, cycle=True)),
    "linear_warmup_const": ("LinearWarmup", (0.3, 5, 0.0, 0.3), {}),
    "exponential": ("ExponentialDecay", (0.5, 0.9), {}),
    "multistep": ("MultiStepDecay", (0.5, [3, 8, 20]), dict(gamma=0.5)),
    "step": ("StepDecay", (0.5, 4), dict(gamma=0.7)),
    "lambda": ("LambdaDecay", (0.5, _LAMBDA), {}),
    "cosine": ("CosineAnnealingDecay", (0.5, 12), dict(eta_min=0.01)),
    "multiplicative": ("MultiplicativeDecay", (0.5, _MULT), {}),
    "one_cycle_cos": ("OneCycleLR", (0.5, 25), {}),
    "one_cycle_linear": ("OneCycleLR", (0.5, 20),
                         dict(anneal_strategy="linear", phase_pct=0.4)),
    "cyclic": ("CyclicLR", (0.01, 0.5), dict(step_size_up=4)),
    "cyclic_triangular2": ("CyclicLR", (0.01, 0.5),
                           dict(step_size_up=3, step_size_down=5,
                                mode="triangular2")),
    "cyclic_exp_range": ("CyclicLR", (0.01, 0.5),
                         dict(step_size_up=3, mode="exp_range",
                              exp_gamma=0.9)),
    "warm_restarts": ("CosineAnnealingWarmRestarts", (0.5, 4),
                      dict(T_mult=2, eta_min=0.01)),
    "linear_lr": ("LinearLR", (0.5, 10),
                  dict(start_factor=0.25, end_factor=1.0)),
    "reduce_on_plateau": ("ReduceOnPlateau", (0.5,),
                          dict(patience=2, factor=0.5, cooldown=1)),
}


def _make(mod, case):
    name, args, kw = CASES[case]
    if case == "linear_warmup_inner":
        return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-4, T_max=12),
                                warmup_steps=3, start_lr=0.0, end_lr=3e-4)
    return getattr(mod, name)(*args, **kw)


CASES["linear_warmup_inner"] = ("LinearWarmup", (), {})

# a metric that improves, stalls and improves again
_METRICS = [5.0, 4.0, 4.0, 4.1, 4.0, 3.0, 3.0, 3.0, 3.5, 3.2] * 3


def _advance(s, i):
    if isinstance(s, (jax_lr.ReduceOnPlateau, pt_lr.ReduceOnPlateau)):
        s.step(_METRICS[i])
    else:
        s.step()


def test_every_reference_scheduler_has_a_case():
    covered = {CASES[c][0] for c in CASES}
    assert covered == set(jax_lr.__all__) - {"LRScheduler"}
    assert pt_lr.__all__ == jax_lr.__all__


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_matches_jax(case):
    """30 steps: the same Python floats, exactly."""
    j, p = _make(jax_lr, case), _make(pt_lr, case)
    jv, pv = [j()], [p()]
    for i in range(STEPS):
        _advance(j, i)
        _advance(p, i)
        jv.append(j())
        pv.append(p())
    assert all(isinstance(v, float) for v in pv)
    assert pv == jv
    assert len(set(pv)) > 1, "the case never moves the LR"


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_state_dict_round_trips(case):
    """The state after 11 steps, loaded into a fresh scheduler (of the
    port, and the JAX one's state into the port's), continues like the
    original; the port's state dict equals JAX's."""
    j, p = _make(jax_lr, case), _make(pt_lr, case)
    for i in range(11):
        _advance(j, i)
        _advance(p, i)
    assert p.state_dict() == j.state_dict()
    fresh, from_jax = _make(pt_lr, case), _make(pt_lr, case)
    fresh.set_state_dict(p.state_dict())
    from_jax.set_state_dict(j.state_dict())
    for i in range(11, STEPS):
        for s in (p, fresh, from_jax, j):
            _advance(s, i)
        assert fresh() == p() == from_jax() == j()
    if case == "linear_warmup_inner":
        assert fresh.inner.last_epoch == p.inner.last_epoch > 0


def test_linear_warmup_nests_the_inner_state():
    s = _make(pt_lr, "linear_warmup_inner")
    for _ in range(6):
        s.step()
    state = s.state_dict()
    assert state["inner"]["last_epoch"] == 3
    assert state["inner"]["last_lr"] == s.inner.last_lr == s()
    copy = dict(state)
    _make(pt_lr, "linear_warmup_inner").set_state_dict(copy)
    assert "inner" in copy          # the caller's dict is left whole


@pytest.mark.parametrize("case", ["linear_warmup_inner", "cyclic",
                                  "reduce_on_plateau"])
def test_bound_lr_tensor_follows_the_scheduler(case):
    """An optimizer built on a scheduler starts at its value and, after
    each ``step()``, holds its value as fp32; ``get_lr`` reads the
    scheduler; ``set_lr_scheduler`` rebinds."""
    s = _make(pt_lr, case)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = pt_optimizer.SGD(learning_rate=s, parameters=[p])
    assert float(opt._lr_tensor) == np.float32(s())
    for i in range(12):
        _advance(s, i)
        assert float(opt._lr_tensor) == np.float32(s())
        assert opt.get_lr() == s()
    other = pt_lr.StepDecay(0.25, 2)
    opt.set_lr_scheduler(other)
    assert float(opt._lr_tensor) == 0.25
    other.step(epoch=5)
    assert float(opt._lr_tensor) == np.float32(0.25 * 0.1 ** 2)
    assert opt.state_dict()["LR_Scheduler"] == other.state_dict()


def test_set_lr_and_plain_float_lr():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = pt_optimizer.SGD(learning_rate=0.5, parameters=[p])
    assert opt.get_lr() == 0.5 and "LR_Scheduler" not in opt.state_dict()
    opt.set_lr(0.125)
    assert opt.get_lr() == 0.125
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.full((3,), -0.125))
    with pytest.raises(TypeError, match="LRScheduler"):
        pt_optimizer.SGD(learning_rate="0.1", parameters=[p])
    assert math.isfinite(opt.get_lr())
