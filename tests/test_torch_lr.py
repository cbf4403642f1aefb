"""The port's learning-rate schedulers (paddle_tpu_torch/optimizer/lr.py)
against the reference package's (paddle_tpu/optimizer/lr.py), on the
CPU: every schedule stepped 30 times from the same arguments, with the
rate, ``last_epoch`` and ``state_dict()`` compared after each step.
The schedules are pure Python floats in both packages, so everything is
held bit for bit (``==``), no tolerance.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30

#: (id, class name, positional args, keyword args); lambdas are built per
#: package from the same function
CASES = [
    ("noam", "NoamDecay", (64, 5), dict(learning_rate=1.0)),
    ("piecewise", "PiecewiseDecay", ([3, 8, 20], [0.1, 0.05, 0.01, 0.001]),
     {}),
    ("natural_exp", "NaturalExpDecay", (0.5,), dict(gamma=0.1)),
    ("inverse_time", "InverseTimeDecay", (0.5,), dict(gamma=0.2)),
    ("polynomial", "PolynomialDecay", (0.1, 10),
     dict(end_lr=0.001, power=2.0)),
    ("polynomial_cycle", "PolynomialDecay", (0.1, 7),
     dict(end_lr=0.001, power=1.5, cycle=True)),
    ("exponential", "ExponentialDecay", (0.1,), dict(gamma=0.9)),
    ("multi_step", "MultiStepDecay", (0.1, [5, 12, 20]), dict(gamma=0.5)),
    ("step", "StepDecay", (0.1, 7), dict(gamma=0.3)),
    ("lambda", "LambdaDecay", (0.1, lambda e: 0.95 ** e), {}),
    ("cosine", "CosineAnnealingDecay", (0.1, 12), dict(eta_min=0.001)),
    ("cosine_restarts", "CosineAnnealingWarmRestarts", (0.1, 4),
     dict(T_mult=2, eta_min=0.0005)),
    ("one_cycle_cos", "OneCycleLR", (0.1, 25), {}),
    ("one_cycle_linear", "OneCycleLR", (0.1, 20),
     dict(divide_factor=10.0, phase_pct=0.25, anneal_strategy="linear")),
    ("cyclic", "CyclicLR", (0.01, 0.1, 4), dict(step_size_down=6)),
    ("cyclic_triangular2", "CyclicLR", (0.01, 0.1, 3),
     dict(mode="triangular2")),
    ("cyclic_exp_range", "CyclicLR", (0.01, 0.1, 5),
     dict(mode="exp_range", exp_gamma=0.95)),
    ("multiplicative", "MultiplicativeDecay", (0.1, lambda e: 0.9), {}),
    ("linear_lr", "LinearLR", (0.1, 10),
     dict(start_factor=0.25, end_factor=1.0)),
    ("warmup_float", "LinearWarmup", (0.1, 5, 0.0, 0.1), {}),
]


def _make(mod, cls, args, kw):
    return getattr(mod, cls)(*args, **kw)


def _nested(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-4, T_max=20), 5,
                            0.0, 3e-4)


def _trace(sched, steps=STEPS):
    out = []
    for _ in range(steps):
        out.append((sched(), sched.last_epoch, sched.state_dict()))
        sched.step()
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_schedule_matches_reference(case):
    _, cls, args, kw = case
    assert _trace(_make(tlr, cls, args, kw)) == _trace(
        _make(jlr, cls, args, kw))


def test_warmup_over_a_nested_scheduler_matches_reference():
    t, j = _nested(tlr), _nested(jlr)
    got, want = _trace(t), _trace(j)
    assert got == want
    # the nested scheduler follows the warm-up's epochs after warm-up
    assert t.lr_after.last_epoch == j.lr_after.last_epoch == STEPS - 5


def test_warmup_rejects_an_int_rate_as_the_reference_does():
    # only a float or a scheduler is taken (lr.py: ``.base_lr`` of an int)
    for mod in (tlr, jlr):
        with pytest.raises(AttributeError):
            mod.LinearWarmup(1, 5, 0.0, 0.1)


def test_step_with_an_explicit_epoch():
    t = tlr.StepDecay(0.1, 3, gamma=0.5)
    j = jlr.StepDecay(0.1, 3, gamma=0.5)
    for epoch in (4, 9, 2, 30):
        t.step(epoch)
        j.step(epoch)
        assert (t(), t.last_epoch) == (j(), j.last_epoch)


@pytest.mark.parametrize("kw", [
    dict(mode="min", patience=2, cooldown=1),
    dict(mode="max", patience=1, factor=0.5, threshold_mode="abs",
         threshold=0.05, min_lr=0.004),
], ids=["min_rel_cooldown", "max_abs_min_lr"])
def test_reduce_on_plateau_matches_reference(kw):
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 8),
                              0.5 + 0.01 * rng.normal(size=22)])
    t = tlr.ReduceOnPlateau(0.1, **kw)
    j = jlr.ReduceOnPlateau(0.1, **kw)
    seq_t, seq_j = [], []
    for i, m in enumerate(metrics):
        # a torch scalar for the port, a paddle Tensor for the reference
        t.step(torch.tensor(np.float32(m)) if i % 2 else float(m))
        j.step(paddle.to_tensor(np.float32(m)) if i % 2 else float(m))
        seq_t.append((t(), t.last_epoch, t.state_dict()))
        seq_j.append((j(), j.last_epoch, j.state_dict()))
    t.step()            # no metric: no step
    j.step()
    assert seq_t == seq_j and t.last_epoch == j.last_epoch == len(metrics)
    assert min(x[0] for x in seq_t) < 0.1      # the rate did drop


@pytest.mark.parametrize("make", [
    lambda mod: mod.CosineAnnealingWarmRestarts(0.1, 4, T_mult=2),
    lambda mod: mod.OneCycleLR(0.1, 25),
    _nested,
], ids=["warm_restarts", "one_cycle", "nested_warmup"])
def test_state_dict_round_trip_continues_identically(make):
    full = make(tlr)
    want = _trace(full, 18)
    head, ref = make(tlr), make(jlr)
    _trace(head, 7)
    _trace(ref, 7)
    sd = head.state_dict()
    assert sd == ref.state_dict()
    resumed = make(tlr)
    resumed.set_state_dict(sd)
    assert _trace(resumed, 11) == want[7:]
    assert resumed() == full()
