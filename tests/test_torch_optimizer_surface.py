"""The port's optimizer surface (paddle_tpu_torch/optimizer,
paddle_tpu_torch/regularizer.py) against the reference package's, on the
CPU: the same starting values and gradient sequence, three steps, for
every optimizer in fp32, in bf16 with ``multi_precision`` (fp32 masters)
and in bf16 without; then the options a training recipe sets:
regularizers (a parameter's own overriding the optimizer's),
``optimize_attr`` rates, schedulers, AdamW's ``lr_ratio`` and
``apply_decay_param_fun``, ``grad_clip``, parameter groups, parameters
without a gradient in the multi-tensor update, and ``state_dict`` with
``LR_Scheduler`` and named keys.

Tolerances as in test_torch_optimizer.py: fp32 parameters, masters and
accumulators within 1e-6 absolute; bf16 parameters within one bf16 ulp
(2 ** -7 relative).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu.regularizer as jreg
from paddle_tpu.core.tensor import Parameter

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.optimizer as topt
import paddle_tpu_torch.regularizer as treg

SHAPES = [(7, 5), (5,), (3, 4, 2), (6,)]
BF16_ULP = 2.0 ** -7
ATOL = 1e-6

REF = types.SimpleNamespace(opt=jopt, lr=jopt.lr, reg=jreg, nn=jnn)
PORT = types.SimpleNamespace(opt=topt, lr=topt.lr, reg=treg, nn=tnn)


def _values(seed, steps):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


def _run(make, dtype=torch.float32, steps=3, seed=0, attrs=None,
         no_grad=(), named=False, start_step=0):
    """Both packages through ``steps`` optimizer steps: ``make(pkg,
    params)`` builds the optimizer, ``attrs(pkg, i)`` gives attributes to
    set on parameter i, ``no_grad`` holds (step, i) pairs whose gradient
    is left out, ``named`` names parameter i ``w<i>`` (the port through
    ``(name, param)`` pairs), ``start_step`` sets the step count first. A
    scheduler given as the rate is stepped after each step."""
    params, grads = _values(seed, steps)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jps = [Parameter(jnp.asarray(p, jdt)) for p in params]
    tps = [torch.nn.Parameter(torch.tensor(p).to(dtype)) for p in params]
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        jp.name = f"w{i}"
        for pkg, p in ((REF, jp), (PORT, tp)):
            for k, v in (attrs(pkg, i) if attrs else {}).items():
                setattr(p, k, v)
    jo = make(REF, jps)
    to = make(PORT, [(f"w{i}", p) for i, p in enumerate(tps)]
              if named else tps)
    for o in (jo, to):
        o.set_state_dict({"__step__": start_step})
    for s, step in enumerate(grads):
        for i, (jp, tp, g) in enumerate(zip(jps, tps, step)):
            if (s, i) in no_grad:
                continue
            jp.grad = paddle.to_tensor(np.asarray(jnp.asarray(g, jdt)))
            tp.grad = torch.tensor(g).to(dtype)
        assert jo.get_lr() == to.get_lr()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        for o in (jo, to):
            if isinstance(o._learning_rate, (jopt.lr.LRScheduler,
                                             topt.lr.LRScheduler)):
                o._learning_rate.step()
    return jo, to, jps, tps


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _check(jo, to, jps, tps):
    """Parameters, masters and every accumulator of the two optimizers."""
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        got, want = tp.detach().float().numpy(), _f32(jp._value)
        if tp.dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=f"param {i}")
        else:
            np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0,
                                       err_msg=f"param {i}")
    assert set(to._master_weights) == {id(tp) for jp, tp in zip(jps, tps)
                                       if id(jp) in jo._master_weights}
    for jp, tp in zip(jps, tps):
        if id(tp) in to._master_weights:
            master = to._master_weights[id(tp)]
            np.testing.assert_allclose(master.numpy(),
                                       _f32(jo._master_weights[id(jp)]),
                                       rtol=0, atol=ATOL)
            torch.testing.assert_close(tp.detach(), master.to(tp.dtype),
                                       rtol=0, atol=0)
    for name in to._accum_names:
        for i, (jp, tp) in enumerate(zip(jps, tps)):
            have_t = id(tp) in to._accumulators[name]
            assert have_t == (id(jp) in jo._accumulators[name]), (name, i)
            if have_t:
                np.testing.assert_allclose(
                    to._accumulators[name][id(tp)].numpy(),
                    _f32(jo._accumulators[name][id(jp)]), rtol=0, atol=ATOL,
                    err_msg=f"{name} of param {i}")


OPTIMIZERS = [
    ("sgd", lambda k, ps, mp: k.opt.SGD(0.05, parameters=ps,
                                        multi_precision=mp)),
    ("momentum", lambda k, ps, mp: k.opt.Momentum(
        0.05, momentum=0.9, parameters=ps, multi_precision=mp)),
    ("momentum_nesterov_l2", lambda k, ps, mp: k.opt.Momentum(
        0.05, momentum=0.8, parameters=ps, use_nesterov=True,
        weight_decay=0.02, multi_precision=mp)),
    ("adam", lambda k, ps, mp: k.opt.Adam(0.05, parameters=ps,
                                          multi_precision=mp)),
    ("adamw", lambda k, ps, mp: k.opt.AdamW(0.05, parameters=ps,
                                            weight_decay=0.1,
                                            multi_precision=mp)),
    ("rmsprop", lambda k, ps, mp: k.opt.RMSProp(
        0.01, rho=0.9, parameters=ps, multi_precision=mp)),
    ("rmsprop_centered", lambda k, ps, mp: k.opt.RMSProp(
        0.01, rho=0.9, momentum=0.5, centered=True, parameters=ps,
        multi_precision=mp)),
    ("adagrad", lambda k, ps, mp: k.opt.Adagrad(
        0.05, parameters=ps, initial_accumulator_value=0.1,
        multi_precision=mp)),
    ("adadelta", lambda k, ps, mp: k.opt.Adadelta(
        1.0, rho=0.9, parameters=ps, multi_precision=mp)),
    ("adamax", lambda k, ps, mp: k.opt.Adamax(0.05, parameters=ps,
                                              multi_precision=mp)),
    ("lamb", lambda k, ps, mp: k.opt.Lamb(
        0.05, lamb_weight_decay=0.1, parameters=ps, multi_precision=mp,
        exclude_from_weight_decay_fn=lambda p: p.ndim == 1)),
    ("asgd", lambda k, ps, mp: k.opt.ASGD(0.05, batch_num=2, parameters=ps,
                                          multi_precision=mp)),
    ("radam", lambda k, ps, mp: k.opt.RAdam(0.05, parameters=ps,
                                            multi_precision=mp)),
    ("rprop", lambda k, ps, mp: k.opt.Rprop(
        0.01, learning_rate_range=(1e-4, 0.05), parameters=ps,
        multi_precision=mp)),
    ("nadam", lambda k, ps, mp: k.opt.NAdam(0.05, parameters=ps,
                                            multi_precision=mp)),
]
VARIANTS = {"fp32": (torch.float32, False), "bf16_master": (torch.bfloat16,
                                                            True),
            "bf16": (torch.bfloat16, False)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", OPTIMIZERS, ids=[c[0] for c in OPTIMIZERS])
def test_optimizer_matches_reference(case, variant):
    dtype, mp = VARIANTS[variant]
    _check(*_run(lambda k, ps: case[1](k, ps, mp), dtype))


@pytest.mark.parametrize("beta2", [0.999, 0.9])
def test_radam_rectified_branch_matches_reference(beta2):
    # rho_t > 5 only from about step 6 at beta2 0.999: start at step 50
    _check(*_run(lambda k, ps: k.opt.RAdam(0.05, beta2=beta2, parameters=ps),
                 start_step=50))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regularizers_and_per_parameter_rates(dtype):
    # the optimizer's L1, overridden by a parameter's own L2; one
    # parameter at half the rate (optimize_attr)
    def attrs(k, i):
        a = {}
        if i == 1:
            a["regularizer"] = k.reg.L2Decay(0.3)
        if i == 2:
            a["optimize_attr"] = {"learning_rate": 0.5}
        return a

    for make in (lambda k, ps: k.opt.Momentum(
                     0.05, parameters=ps, weight_decay=k.reg.L1Decay(0.1)),
                 lambda k, ps: k.opt.Adam(0.05, parameters=ps,
                                          weight_decay=0.02)):
        _check(*_run(make, dtype, attrs=attrs))


def test_adamw_recipe_options_match_reference():
    # warm-up then cosine, lr_ratio, no decay on the 1-D parameters by
    # name, a global-norm clip that binds, fp32 masters of bf16 weights
    def make(k, ps):
        sched = k.lr.LinearWarmup(k.lr.CosineAnnealingDecay(0.05, T_max=4),
                                  warmup_steps=2, start_lr=0.0, end_lr=0.05)
        return k.opt.AdamW(
            sched, parameters=ps, weight_decay=0.1, multi_precision=True,
            lr_ratio=lambda p: 0.5 if p.ndim == 3 else 1.0,
            apply_decay_param_fun=lambda n: n not in ("w1", "w3"),
            grad_clip=k.nn.ClipGradByGlobalNorm(1.0))

    jo, to, jps, tps = _run(make, torch.bfloat16, steps=5, named=True)
    _check(jo, to, jps, tps)
    assert jo.get_lr() == to.get_lr() == to._learning_rate()
    sd = to.state_dict()
    assert sd["LR_Scheduler"] == jo.state_dict()["LR_Scheduler"]
    assert {k.rpartition("__")[0] for k in sd
            if k not in ("__step__", "LR_Scheduler")} == {"w0", "w1", "w2",
                                                          "w3"}


def test_multi_tensor_update_skips_parameters_without_a_gradient():
    # w2 has no gradient at step 0 (no moments yet) and w0 none at step 1
    for make in (lambda k, ps: k.opt.AdamW(0.05, parameters=ps,
                                           multi_precision=True),
                 lambda k, ps: k.opt.Adam(0.05, parameters=ps)):
        _check(*_run(make, torch.bfloat16, no_grad={(0, 2), (1, 0)}))


def test_mixed_dtypes_update_in_groups():
    # fp32 and bf16 parameters in one AdamW: one multi-tensor update per
    # (device, dtype, master) group
    params, grads = _values(5, 3)
    dts = [torch.float32, torch.bfloat16, torch.float32, torch.bfloat16]
    tps = [torch.nn.Parameter(torch.tensor(p).to(d))
           for p, d in zip(params, dts)]
    ref = [torch.nn.Parameter(p.detach().clone()) for p in tps]
    opt = topt.AdamW(0.05, parameters=tps, multi_precision=True)
    alone = [topt.AdamW(0.05, parameters=[p], multi_precision=True)
             for p in ref]
    for step in grads:
        for p, q, g, d in zip(tps, ref, step, dts):
            p.grad = torch.tensor(g).to(d)
            q.grad = torch.tensor(g).to(d)
        opt.step()
        for o in alone:
            o.step()
    for p, q in zip(tps, ref):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_parameter_groups_keep_their_keys_and_change_nothing():
    # the reference stores a group's other keys and never reads them
    def make(k, ps):
        return k.opt.AdamW(0.05, parameters=[
            {"params": ps[:2], "learning_rate": 0.5, "weight_decay": 0.9},
            {"params": ps[2:]}])

    jo, to, jps, tps = _run(make)
    _check(jo, to, jps, tps)
    assert to._param_groups[0]["learning_rate"] == 0.5
    assert [len(g["params"]) for g in to._param_groups] == [2, 2]


def test_named_state_dict_round_trip_continues_identically():
    params, grads = _values(6, 4)

    def make():
        ps = [torch.nn.Parameter(torch.tensor(p).bfloat16()) for p in params]
        sched = topt.lr.StepDecay(0.05, step_size=2, gamma=0.5)
        return ps, topt.AdamW(sched, parameters=[(f"layer{i}.w", p) for i, p
                                                  in enumerate(ps)],
                              multi_precision=True)

    def step(ps, opt, g):
        for p, gi in zip(ps, g):
            p.grad = torch.tensor(gi).bfloat16()
        opt.minimize(None)
        opt.clear_gradients()
        opt._learning_rate.step()

    a_ps, a = make()
    for g in grads:
        step(a_ps, a, g)
    b_ps, b = make()
    for g in grads[:3]:
        step(b_ps, b, g)
    sd = b.state_dict()
    assert "layer0.w__moment1" in sd and "layer3.w__master" in sd
    assert sd["LR_Scheduler"]["last_epoch"] == 3
    c_ps, c = make()
    with torch.no_grad():
        for p, q in zip(c_ps, b_ps):
            p.copy_(q)
    c.load_state_dict({k: (v.clone() if torch.is_tensor(v) else v)
                       for k, v in sd.items()})
    assert c.get_lr() == b.get_lr()
    step(c_ps, c, grads[3])
    for p, q in zip(a_ps, c_ps):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_set_lr_and_set_lr_scheduler():
    p = [torch.nn.Parameter(torch.zeros(3))]
    o = topt.SGD(0.1, parameters=p)
    o.set_lr(0.25)
    assert o.get_lr() == 0.25
    o.set_lr_scheduler(topt.lr.ExponentialDecay(0.5, gamma=0.5))
    o._learning_rate.step()
    assert o.get_lr() == 0.25
