"""The port's optimizers (paddle_tpu_torch/optimizer) against the
reference package's (paddle_tpu/optimizer), on the CPU: the same
starting values and the same gradient sequence, three steps.

Tolerances: fp32 parameters, master weights and moments within 1e-6
absolute (values of magnitude < 2; the two packages round constants such
as 1 - beta1 and beta1 ** t in different precisions, a few ulps of an
update of size ~lr). bf16 parameters within one bf16 ulp (2 ** -7
relative): each is its fp32 master rounded once, so masters that differ
in the last fp32 bits may round to neighbouring bf16 values. The
gradients here are O(1), far above Adam's epsilon, so the sign
sensitivity of near-zero gradients (an update of ±lr either way) does
not arise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter

import paddle_tpu_torch.optimizer as topt

SHAPES = [(7, 5), (5,), (3, 4, 2)]
BF16_ULP = 2.0 ** -7


def _values(seed):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    return params, grads


def _run(jcls, tcls, dtype, seed=0, **kw):
    params, grads = _values(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jps = [Parameter(jnp.asarray(p, jdt)) for p in params]
    tps = [torch.nn.Parameter(torch.from_numpy(p).to(dtype)) for p in params]
    jo = jcls(parameters=jps, **kw)
    to = tcls(parameters=tps, **kw)
    for step in grads:
        for jp, tp, g in zip(jps, tps, step):
            jp.grad = paddle.to_tensor(np.asarray(jnp.asarray(g, jdt)))
            tp.grad = torch.from_numpy(g).to(dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    assert all(p.grad is None for p in tps)
    return jo, to, jps, tps


def _f32(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("cls", ["AdamW", "Adam", "SGD"])
def test_fp32_steps_match(cls):
    kw = dict(learning_rate=0.05)
    if cls != "SGD":
        kw["weight_decay"] = 0.02
    jo, to, jps, tps = _run(getattr(jopt, cls), getattr(topt, cls),
                            torch.float32, **kw)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), _f32(jp._value),
                                   rtol=0, atol=1e-6)
    if cls != "SGD":
        for name in ("moment1", "moment2"):
            for jp, tp in zip(jps, tps):
                np.testing.assert_allclose(
                    to._accumulators[name][id(tp)].numpy(),
                    _f32(jo._accumulators[name][id(jp)]), rtol=0, atol=1e-6)


def test_adamw_multi_precision_bf16_matches():
    # bench_llama's optimizer: AdamW(multi_precision=True), weight decay
    # 0.01, on bf16 parameters with fp32 master weights
    jo, to, jps, tps = _run(jopt.AdamW, topt.AdamW, torch.bfloat16,
                            learning_rate=0.05, multi_precision=True)
    for jp, tp in zip(jps, tps):
        master = to._master_weights[id(tp)]
        assert master.dtype == torch.float32 and tp.dtype == torch.bfloat16
        np.testing.assert_allclose(master.numpy(),
                                   _f32(jo._master_weights[id(jp)]),
                                   rtol=0, atol=1e-6)
        # the parameter is its master rounded once
        torch.testing.assert_close(tp.detach(), master.bfloat16(),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   _f32(jp._value), rtol=BF16_ULP, atol=0)
    sd = to.state_dict()
    assert sd["__step__"] == 3
    assert sorted(k for k in sd if k.startswith("param_0")) == [
        "param_0__master", "param_0__moment1", "param_0__moment2"]


def test_state_dict_round_trip_continues_identically():
    params, grads = _values(4)

    def make():
        ps = [torch.nn.Parameter(torch.from_numpy(p).bfloat16())
              for p in params]
        return ps, topt.AdamW(learning_rate=0.1, parameters=ps,
                              multi_precision=True)

    def step(ps, opt, g):
        for p, gi in zip(ps, g):
            p.grad = torch.from_numpy(gi).bfloat16()
        opt.step()

    a_ps, a = make()
    for g in grads:
        step(a_ps, a, g)
    b_ps, b = make()
    for g in grads[:2]:
        step(b_ps, b, g)
    c_ps, c = make()
    with torch.no_grad():
        for p, q in zip(c_ps, b_ps):
            p.copy_(q)
    c.set_state_dict({k: (v.clone() if torch.is_tensor(v) else v)
                      for k, v in b.state_dict().items()})
    step(c_ps, c, grads[2])
    for p, q in zip(a_ps, c_ps):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_unported_options_raise():
    # what the port still refuses; grad_clip, schedulers, lr_ratio,
    # apply_decay_param_fun and group options are held against the
    # reference in test_torch_optimizer_surface.py
    from paddle_tpu_torch import amp

    with pytest.raises(ValueError, match="parameters"):
        topt.Adam()
    for kw in (dict(custom_white_list=["matmul"]),
               dict(custom_black_list={"softmax_p"})):
        with pytest.raises(NotImplementedError, match="custom_white_list"):
            amp.auto_cast(**kw)
