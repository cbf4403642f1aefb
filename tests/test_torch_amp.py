"""The port's ``amp`` (paddle_tpu_torch/amp) against the reference
package's (paddle_tpu/amp), on the CPU.

- ``GradScaler``: the scale, good-step and bad-step sequences and the
  skipped steps equal the reference's exactly (the parameters, which SGD
  moves, within 1e-6) over a gradient sequence with injected inf and
  NaN, the reference's two quirks included (``step()`` already calls
  ``update()``; the scale never drops below 1).
- ``auto_cast`` on the tiny Llama from the same weights and batch
  (test_torch_train.py's). O2 (``decorate`` casts the model to half):
  loss and every parameter gradient against the reference's O2. O1: the
  reference's backward raises (its amp cast hands a half cotangent to an
  fp32 producer: ``unexpected JAX type ... for argument to VJP
  function``), so the loss is held against the reference's O1 forward
  and the gradients against the reference's fp32 gradients. RMSNorm
  receives the fp32 residual stream under O1 in the port, as in the
  reference (black list); the layers' projections and attention give
  the half dtype; the O1 loss lies nearer the reference's O1 loss than
  the port's own fp32 loss, and every O1 gradient differs from the
  port's fp32 one by at least eps(dtype) / 8 of its max |g|, so a port
  left in fp32 fails.
  Tolerances (half precision, measured first): loss within eps(dtype)
  relative (measured: bf16 8.4e-4 absolute on 5.79, fp16 8.1e-5), each
  gradient within 4 * eps(dtype) of its own max |g| (measured: bf16 up
  to 0.021, fp16 up to 0.0027; eps = 2 ** -7 bf16, 2 ** -10 fp16).
- The port's own autograd Functions under autocast (flash attention and
  RMSNorm; ``core/autocast.py``): fp32 attention inputs run as their
  half casts, RMSNorm in its input dtype, bit for bit as outside
  autocast.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp, load_paddle_tpu_state
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF

from test_torch_train import _batch

HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _scaler_run(scaler_kw, grads, extra_update=False):
    """Both packages: SGD on two parameters, each step's gradients
    (already scaled, inf/NaN injected by the caller) through
    ``scaler.step``; returns each package's per-step (state, params)."""
    import jax.numpy as jnp

    init = [np.linspace(-1, 1, 6).astype(np.float32).reshape(2, 3),
            np.array([0.5, -0.25], np.float32)]
    jps = [Parameter(jnp.asarray(a)) for a in init]
    tps = [torch.nn.Parameter(torch.tensor(a)) for a in init]
    js, ts = paddle.amp.GradScaler(**scaler_kw), amp.GradScaler(**scaler_kw)
    jo, to = jopt.SGD(0.1, parameters=jps), topt.SGD(0.1, parameters=tps)
    out = {"ref": [], "port": []}
    for step in grads:
        for jp, tp, g in zip(jps, tps, step):
            jp._grad_value = jnp.asarray(g)
            tp.grad = torch.tensor(g)
        js.step(jo)
        ts.step(to)
        if extra_update:
            js.update()
            ts.update()
        jo.clear_grad()
        to.clear_grad()
        out["ref"].append((js.state_dict(), [np.asarray(p._value).tolist()
                                             for p in jps]))
        out["port"].append((ts.state_dict(), [p.detach().numpy().tolist()
                                              for p in tps]))
    return out


def _scaled_grads(seed, bad_steps, n=9, scale=8.0):
    rng = np.random.default_rng(seed)
    grads = []
    for s in range(n):
        g = [scale * rng.normal(size=(2, 3)).astype(np.float32),
             scale * rng.normal(size=(2,)).astype(np.float32)]
        if s in bad_steps:
            g[s % 2].flat[s % 2] = np.inf if s % 3 else np.nan
        grads.append(g)
    return grads


@pytest.mark.parametrize("kw, extra_update", [
    (dict(init_loss_scaling=8.0, incr_every_n_steps=2), False),
    (dict(init_loss_scaling=2.0, incr_every_n_steps=3,
          decr_every_n_nan_or_inf=2, decr_ratio=0.25), False),
    (dict(init_loss_scaling=8.0, incr_every_n_steps=2), True),
], ids=["incr2", "decr2_floor", "step_then_update"])
def test_grad_scaler_sequence_matches_reference(kw, extra_update):
    bad = {2, 3, 6, 7}
    out = _scaler_run(kw, _scaled_grads(0, bad), extra_update)
    assert [s for s, _ in out["port"]] == [s for s, _ in out["ref"]]
    scales = [s["scale"] for s, _ in out["port"]]
    assert len(set(scales)) > 1           # the scale moved
    for i, ((_, tp), (_, jp)) in enumerate(zip(out["port"], out["ref"])):
        for t, j in zip(tp, jp):
            # SGD's update: fp32 within 1e-6 (test_torch_optimizer.py's)
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
        if i in bad:                      # skipped: nothing moved
            assert tp == out["port"][i - 1][1]


def test_grad_scaler_api():
    for mod in (amp, paddle.amp):
        s = mod.GradScaler(init_loss_scaling=128.0)
        assert s.is_enable() and s.is_use_dynamic_loss_scaling()
        assert float(s.get_loss_scaling()) == 128.0
        off = mod.GradScaler(enable=False, init_loss_scaling=128.0)
        assert float(off.get_loss_scaling()) == 1.0
    loss = torch.tensor(0.75)
    assert float(amp.GradScaler(init_loss_scaling=4.0).scale(loss)) == 3.0
    assert amp.GradScaler(enable=False).scale(loss) is loss
    s = amp.GradScaler()
    s.load_state_dict({"scale": 4.0, "good_steps": 3, "bad_steps": 1})
    assert s.state_dict() == {"scale": 4.0, "good_steps": 3, "bad_steps": 1}
    assert amp.is_bfloat16_supported() == paddle.amp.is_bfloat16_supported()
    assert amp.is_float16_supported() == paddle.amp.is_float16_supported()
    assert amp.is_bfloat16_supported("cpu")


def _llama_pair(kw):
    paddle.seed(7)
    jm = JLlama(JConfig.tiny(**kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._value)
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _grads_close(jm, tm, half):
    """Every port gradient within 4 eps of the reference gradient's max
    |g| (the reference's layout: Linear weights transposed)."""
    tol = 4 * torch.finfo(half).eps
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    tparams = dict(tm.named_parameters())
    for name, jp in jm.named_parameters():
        jg = np.asarray(jp.grad._value).astype(np.float32)
        tg = tparams[name].grad.float().numpy()
        if name.rsplit(".", 1)[0] in linear:
            tg = tg.T
        np.testing.assert_allclose(tg, jg, rtol=0,
                                   atol=tol * np.abs(jg).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce",
                                                       "unfused_ce"])
def test_o2_llama_matches_reference(dtype, fused):
    half = HALF[dtype]
    jm, tm = _llama_pair(dict(fused_lm_head_ce=fused))
    assert paddle.amp.decorate(jm, level="O2", dtype=dtype) is jm
    assert amp.decorate(tm, level="O2", dtype=dtype) is tm
    assert all(p.dtype == half for p in tm.parameters())
    ids, labels = _batch(16)
    with paddle.amp.auto_cast(level="O2", dtype=dtype):
        jl, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jl.backward()
    with amp.auto_cast(level="O2", dtype=dtype):
        tl, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tl.backward()
    eps = torch.finfo(half).eps
    assert abs(tl.item() - float(jl)) <= eps * abs(float(jl))
    _grads_close(jm, tm, half)


@pytest.mark.parametrize("dtype", list(HALF))
def test_o1_llama_matches_reference(dtype):
    half = HALF[dtype]
    jm, tm = _llama_pair({})
    ids, labels = _batch(16)
    jids, jlabels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    with paddle.amp.auto_cast(level="O1", dtype=dtype):
        j_amp, _ = jm(jids, labels=jlabels)
        with pytest.raises(ValueError, match="VJP"):
            j_amp.backward()
    jm.clear_gradients()
    jl, _ = jm(jids, labels=jlabels)           # fp32 gradients
    jl.backward()
    t32, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    t32.backward()                             # the port's fp32 run
    g32 = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad()
    norm_inputs, seen = [], {}

    def note(key, t):                          # a hook that returns None
        seen[key] = t.dtype

    hooks = [m.register_forward_pre_hook(
        lambda m, a: norm_inputs.append(a[0].dtype))
        for n, m in tm.named_modules() if n.endswith("norm")]
    for n, m in tm.named_modules():
        if ".layers." in n and isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(
                lambda m, a, out, n=n: note(n, out)))
        if n.endswith("o_proj"):               # its input: attention's out
            hooks.append(m.register_forward_pre_hook(
                lambda m, a, n=n: note(n + " input", a[0])))
    with amp.auto_cast(level="O1", dtype=dtype):
        tl, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tl.backward()
    for h in hooks:
        h.remove()
    assert set(norm_inputs) == {torch.float32} and len(norm_inputs) == 5
    # the projections and attention ran in the half dtype
    assert any(n.endswith("o_proj input") for n in seen)
    assert any(n.endswith("down_proj") for n in seen)
    assert set(seen.values()) == {half}, seen
    eps = torch.finfo(half).eps
    assert abs(tl.item() - float(j_amp)) <= eps * abs(float(j_amp))
    # nearer the reference's O1 loss than the port's own fp32 loss, and
    # every gradient at least eps / 8 of its max |g| away from the fp32
    # one (measured: bf16 2.1x nearer, gradients 0.0042-0.014 apart;
    # fp16 2.6x, 5.8e-4-2.7e-3)
    assert abs(tl.item() - t32.item()) > abs(tl.item() - float(j_amp))
    for n, p in tm.named_parameters():
        assert (p.grad - g32[n]).abs().max() > \
            eps / 8 * g32[n].abs().max(), n
    _grads_close(jm, tm, half)


@pytest.mark.parametrize("dtype", list(HALF))
def test_port_functions_under_autocast(dtype):
    half = HALF[dtype]
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=(2, 32, 2, 64)).astype(
        np.float32), requires_grad=True) for _ in range(3))
    x = torch.tensor(rng.normal(size=(4, 64)).astype(np.float32))
    w = torch.tensor(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    with amp.auto_cast(dtype=dtype):
        out = TF.scaled_dot_product_attention(q, k, v, is_causal=True)
        y = TF.rms_norm(x, w)
    out.float().sum().backward()
    hq, hk, hv = (t.detach().to(half).requires_grad_() for t in (q, k, v))
    want = TF.scaled_dot_product_attention(hq, hk, hv, is_causal=True)
    want.float().sum().backward()
    assert out.dtype == half and y.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(q.grad, hq.grad.float(), rtol=0, atol=0)
    torch.testing.assert_close(y, TF.rms_norm(x, w), rtol=0, atol=0)


def test_auto_cast_regions():
    x = torch.randn(4, 4)
    with amp.auto_cast(dtype="float16"):
        assert (x @ x).dtype == torch.float16
        with amp.auto_cast(enable=False):
            assert (x @ x).dtype == torch.float32
    with amp.amp_guard():
        assert (x @ x).dtype == torch.bfloat16
    assert (x @ x).dtype == torch.float32
    m = torch.nn.Linear(3, 3)
    opt = topt.SGD(0.1, parameters=m.parameters())
    assert amp.decorate(m, opt, level="O1") == (m, opt)
    assert m.weight.dtype == torch.float32
    ms = amp.decorate([m], level="O2", dtype="float16")
    assert ms == [m] and m.weight.dtype == torch.float16
