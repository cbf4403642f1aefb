"""The port's ``jit.to_static`` (paddle_tpu_torch/jit) against the
reference's (paddle_tpu/jit) on the CPU, with the same numpy weights:
the reference's ``TestToStatic`` cases (tests/test_jit_amp_io.py), each
run through both packages, and every optimizer's captured update (device
scalars for the rate and the step) against its eager update.

On the CPU nothing is captured: a ``to_static`` entry runs the function
eagerly on its static inputs, with the optimizers reading the rate and
the step count from device scalars as a replayed graph does. The graph
itself runs on the card (chip_smoke.py's ``[train]`` phase).

Tolerances: forward outputs 1e-5 absolute (fp32, the two packages sum in
other orders); the 5-step AdamW losses 2e-4 relative and the weights
2e-5 absolute, the reference test's own bounds; a captured optimizer
update against the same eager update 1e-6 absolute (fp32 values of
magnitude < 2 after five steps; the bias corrections are computed on
the device instead of in numpy, a few ulps).
"""
import gc
import warnings
import weakref

import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import optimizer as topt


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mlp_pair(rng, sizes, act="relu"):
    """The same MLP in both packages from numpy weights: reference Linear
    weights are [in, out], torch's [out, in]."""
    jlayers, tlayers = [], []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w, b = _r(rng, n_in, n_out) * 0.5, _r(rng, n_out) * 0.1
        jl, tl = jnn.Linear(n_in, n_out), torch.nn.Linear(n_in, n_out)
        jl.weight.set_value(w)
        jl.bias.set_value(b)
        with torch.no_grad():
            tl.weight.copy_(torch.from_numpy(w.T))
            tl.bias.copy_(torch.from_numpy(b))
        jlayers.append(jl)
        tlayers.append(tl)
        if i < len(sizes) - 2:
            jlayers.append(jnn.ReLU() if act == "relu" else jnn.Tanh())
            tlayers.append(torch.nn.ReLU() if act == "relu"
                           else torch.nn.Tanh())
    return jnn.Sequential(*jlayers), torch.nn.Sequential(*tlayers)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


class TestToStatic:
    def test_forward_capture_matches_eager(self):
        rng = np.random.default_rng(0)
        jm, tm = _mlp_pair(rng, (8, 16, 4))
        jm.eval()
        tm.eval()
        x = _r(rng, 3, 8)
        want = _np(paddle.jit.to_static(lambda t: jm(t))(paddle.to_tensor(x)))
        fwd = tjit.to_static(lambda t: tm(t))
        got = fwd(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), want, atol=1e-5)
        np.testing.assert_allclose(_np(got), _np(tm(torch.from_numpy(x))),
                                   atol=1e-6)
        assert not got.requires_grad          # outputs are detached copies
        np.testing.assert_array_equal(_np(fwd(torch.from_numpy(x))),
                                      _np(got))
        assert len(fwd._cache) == 1

    def test_recompile_on_new_shape(self):
        rng = np.random.default_rng(1)
        jm, tm = _mlp_pair(rng, (4, 2))
        jf = paddle.jit.to_static(lambda t: jm(t))
        tf = tjit.to_static(lambda t: tm(t))
        for n in (2, 7):
            x = _r(rng, n, 4)
            got = tf(torch.from_numpy(x))
            assert tuple(got.shape) == (n, 2)
            np.testing.assert_allclose(
                _np(got), _np(jf(paddle.to_tensor(x))), atol=1e-5)
        assert len(tf._cache) == 2

    def test_param_update_visible_to_compiled_fn(self):
        rng = np.random.default_rng(2)
        w = _r(rng, 4, 1)
        jm = jnn.Linear(4, 1, bias_attr=False)
        jm.weight.set_value(w)
        tm = torch.nn.Linear(4, 1, bias=False)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(w.T))
        jf = paddle.jit.to_static(lambda t: jm(t))
        tf = tjit.to_static(lambda t: tm(t))
        x = np.ones((1, 4), np.float32)
        y1 = float(tf(torch.from_numpy(x)))
        np.testing.assert_allclose(y1, float(jf(paddle.to_tensor(x))),
                                   rtol=1e-5)
        # an in-place write reaches the captured function as it is
        with torch.no_grad():
            tm.weight.mul_(2)
        jm.weight.set_value(jm.weight.numpy() * 2)
        y2 = float(tf(torch.from_numpy(x)))
        np.testing.assert_allclose(y2, 2 * y1, rtol=1e-5)
        np.testing.assert_allclose(y2, float(jf(paddle.to_tensor(x))),
                                   rtol=1e-5)
        assert len(tf._cache) == 1
        # new storage behind the parameter gives a new entry
        tm.weight.data = tm.weight.data * 3
        np.testing.assert_allclose(float(tf(torch.from_numpy(x))), 6 * y1,
                                   rtol=1e-5)
        assert len(tf._cache) == 2

    def test_full_train_step_matches_eager(self):
        rng = np.random.default_rng(3)
        jm, tm = _mlp_pair(rng, (8, 8, 1), act="tanh")
        _, te = _mlp_pair(np.random.default_rng(3), (8, 8, 1), act="tanh")
        jo = jopt.AdamW(0.01, parameters=jm.parameters())
        to = topt.AdamW(0.01, parameters=tm.parameters())
        eo = topt.AdamW(0.01, parameters=te.parameters())
        X, Y = _r(rng, 16, 8), _r(rng, 16, 1)

        @paddle.jit.to_static
        def jstep(x, y):
            loss = jnn.MSELoss()(jm(x), y)
            loss.backward()
            jo.step()
            jo.clear_grad()
            return loss

        @tjit.to_static
        def tstep(x, y):
            loss = torch.nn.functional.mse_loss(tm(x), y)
            loss.backward()
            to.step()
            to.clear_grad()
            return loss

        for _ in range(5):
            lj = float(jstep(paddle.to_tensor(X), paddle.to_tensor(Y)))
            lt = float(tstep(torch.from_numpy(X), torch.from_numpy(Y)))
            le = torch.nn.functional.mse_loss(te(torch.from_numpy(X)),
                                              torch.from_numpy(Y))
            le.backward()
            eo.step()
            eo.clear_grad()
            np.testing.assert_allclose(lt, lj, rtol=2e-4)
            np.testing.assert_allclose(lt, le.item(), rtol=2e-4)
        assert to._step_count == 5 and len(tstep._cache) == 1
        assert all(p.grad is None for p in tm.parameters())
        np.testing.assert_allclose(_np(tm[0].weight).T,
                                   jm[0].weight.numpy(), atol=2e-5)
        np.testing.assert_allclose(_np(tm[0].weight), _np(te[0].weight),
                                   atol=2e-5)

    def test_decorated_layer(self):
        class M(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.fc = torch.nn.Linear(4, 2)

            def forward(self, x):
                return self.fc(x)

        m = M()
        x = torch.randn(3, 4)
        want = m(x)
        assert tjit.to_static(m) is m
        got = m(x)
        assert tuple(got.shape) == (3, 2)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)
        assert isinstance(m.forward, tjit.StaticFunction)

    def test_dropout_rng_varies_under_jit(self):
        jd = jnn.Dropout(0.5)
        jf = paddle.jit.to_static(lambda t: jd(t))
        x = np.ones((100,), np.float32)
        assert not np.array_equal(jf(paddle.to_tensor(x)).numpy(),
                                  jf(paddle.to_tensor(x)).numpy())
        td = torch.nn.Dropout(0.5)
        tf = tjit.to_static(lambda t: td(t))
        a, b = _np(tf(torch.from_numpy(x))), _np(tf(torch.from_numpy(x)))
        assert not np.array_equal(a, b)      # a fresh mask each call
        assert set(np.unique(a)) <= {0.0, 2.0}

    @pytest.mark.parametrize("full_graph", [True, False])
    def test_grad_scaler_is_a_capture_failure(self, full_graph):
        rng = np.random.default_rng(4)
        jm, tm = _mlp_pair(rng, (4, 1))
        x = _r(rng, 8, 4)
        jo = jopt.SGD(0.01, parameters=jm.parameters())
        to = topt.SGD(0.01, parameters=tm.parameters())
        js = paddle.amp.GradScaler(init_loss_scaling=128.0)
        ts = tamp.GradScaler(init_loss_scaling=128.0)

        def jstep(t):
            loss = jm(t).mean()
            js.scale(loss).backward()
            js.step(jo)
            jo.clear_grad()
            return loss

        def tstep(t):
            loss = tm(t).mean()
            ts.scale(loss).backward()
            ts.step(to)
            to.clear_grad()
            return loss

        jf = paddle.jit.to_static(jstep, full_graph=full_graph)
        tf = tjit.to_static(tstep, full_graph=full_graph)
        label = dict(fn="tstep")
        before = tobs.registry.get("jit.fallbacks").value(**label)
        if full_graph:
            with pytest.raises(Exception):
                jf(paddle.to_tensor(x))
            with pytest.raises(tjit.CaptureError, match="found_inf"):
                tf(torch.from_numpy(x))
            # the failed capture left no gradient and took no step
            assert all(p.grad is None for p in tm.parameters())
            assert to._step_count == 0
            return
        w0 = _np(tm[0].weight).copy()
        with pytest.warns(UserWarning, match="falling back to eager"):
            jl = float(jf(paddle.to_tensor(x)))
        with pytest.warns(UserWarning, match="falling back to eager"):
            tl = float(tf(torch.from_numpy(x)))
        np.testing.assert_allclose(tl, jl, atol=1e-5)
        assert tobs.registry.get("jit.fallbacks").value(**label) == \
            before + 1
        # the fallback's one eager step, gradients once (not twice)
        assert to._step_count == 1
        np.testing.assert_allclose(_np(tm[0].weight).T, jm[0].weight.numpy(),
                                   atol=1e-6)
        assert not np.array_equal(_np(tm[0].weight), w0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tf(torch.from_numpy(x))            # eager now, no new warning
        assert tobs.registry.get("jit.fallbacks").value(**label) == \
            before + 1


def test_a_dropped_function_frees_its_graph_without_the_collector():
    m = torch.nn.Linear(3, 2)
    opt = topt.AdamW(0.01, parameters=m.parameters())

    def step(x):
        loss = m(x).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    f = tjit.to_static(step)
    f(torch.randn(4, 3))
    f(torch.randn(4, 3))
    graphed = weakref.ref(next(iter(f._cache.values())).graphed)
    gc.disable()
    try:
        del f
        assert graphed() is None
    finally:
        gc.enable()


def test_switches_metrics_and_unported_entry_points():
    m = torch.nn.Linear(3, 2)
    f = tjit.to_static(lambda t: m(t))
    x = torch.randn(4, 3)
    hits = tobs.registry.get("jit.cache_hits").value(fn="<lambda>")
    f(x)
    f(x)
    assert tobs.registry.get("jit.cache_hits").value(fn="<lambda>") == \
        hits + 1
    tjit.enable_to_static(False)
    try:
        assert f(x).requires_grad            # the plain function ran
    finally:
        tjit.enable_to_static(True)
    spec = tjit.InputSpec([None, 3], "float32", name="x")
    assert spec.shape == (-1, 3) and spec.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="item 7"):
        tjit.save(m, "unused")
    with pytest.raises(NotImplementedError, match="item 7"):
        tjit.load("unused")


# ---------------------------------------------------------------------------
# every optimizer's captured update = its eager update
# ---------------------------------------------------------------------------
OPTIMIZERS = {
    "SGD": dict(), "Momentum": dict(use_nesterov=True), "Adam": dict(),
    "AdamW": dict(weight_decay=0.05), "RMSProp": dict(centered=True),
    "Adagrad": dict(initial_accumulator_value=0.1), "Adadelta": dict(),
    "Adamax": dict(), "Lamb": dict(), "ASGD": dict(batch_num=2),
    "RAdam": dict(), "Rprop": dict(), "NAdam": dict(),
}


def _train_pair(name, dtype, scheduled):
    """Five steps of the same model, data and optimizer, eager and under
    ``to_static``; returns the two models' parameters as fp32 numpy."""
    rng = np.random.default_rng(5)
    w = [_r(rng, 6, 5), _r(rng, 6), _r(rng, 3, 6)]
    X, Y = _r(rng, 7, 5), _r(rng, 7, 3)
    out = []
    for captured in (False, True):
        ps = [torch.nn.Parameter(torch.from_numpy(a).to(dtype)) for a in w]
        sched = (topt.lr.LinearWarmup(0.02, warmup_steps=3, start_lr=0.0,
                                      end_lr=0.02) if scheduled else 0.02)
        lr = dict(learning_rate=sched)
        kw = dict(OPTIMIZERS[name])
        if name == "RMSProp" or name == "Adagrad":
            o = getattr(topt, name)(sched, parameters=ps, **kw)
        else:
            o = getattr(topt, name)(parameters=ps, **lr, **kw,
                                    **({"multi_precision": True}
                                       if dtype == torch.bfloat16 else {}))

        def step(x, y):
            h = torch.tanh(x.to(dtype) @ ps[0].T + ps[1])
            loss = ((h @ ps[2].T).float() - y).square().mean()
            loss.backward()
            o.step()
            o.clear_grad()
            return loss

        fn = tjit.to_static(step) if captured else step
        for _ in range(5):
            fn(torch.from_numpy(X), torch.from_numpy(Y))
            if scheduled:
                sched.step()
        assert o._step_count == 5
        out.append([p.detach().float().numpy() for p in ps])
    return out


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_captured_update_equals_eager(name):
    eager, captured = _train_pair(name, torch.float32, scheduled=False)
    for a, b in zip(eager, captured):
        np.testing.assert_allclose(b, a, atol=1e-6)


@pytest.mark.parametrize("name", ["AdamW", "SGD", "Lamb"])
def test_captured_update_bf16_masters_and_schedule(name):
    """bf16 parameters with fp32 masters under a warm-up schedule stepped
    outside the function: within one bf16 ulp of the eager run."""
    eager, captured = _train_pair(name, torch.bfloat16, scheduled=True)
    for a, b in zip(eager, captured):
        np.testing.assert_allclose(b, a, atol=0, rtol=2.0 ** -7)
