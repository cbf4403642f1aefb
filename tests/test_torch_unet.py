"""The port's diffusion UNet (paddle_tpu_torch/models/unet_diffusion.py)
against the reference's (paddle_tpu/models/unet_diffusion.py) on the CPU,
fp32, from bridged weights: ``timestep_embedding``,
``DDPMScheduler.add_noise`` and ``step`` (with the reference's noise
given), and for ``UNetConfig.tiny()`` (self-attention over 16 tokens,
cross-attention from them to 8 context tokens, head dim 16: the plain
composition) and a tiny config at head dim 64 (64 query tokens against
77 context tokens, Sk != Sq: the port routes it to the flash kernels'
entry points, whose plain versions run on the CPU) the forward and the
gradients of an MSE training loss, and for the first the parameters
after one ``AdamW`` step. The reference's weights are numpy draws at its
initializers' scales (``_torch_zoo.numpy_init``: its per-shape
``jax.random`` init took 24 s of the head-dim-64 case) and its step runs
as one program under its own ``jit.to_static`` (``_reference_step``). Sampled ``step`` noise is held within the port (an
explicit generator: seed reproducible).

Tolerances: the embedding within 999 x 2 ** -23 absolute (XLA's fp32
``exp`` and torch's round some frequencies one ulp apart, and the
argument ``t x freq`` carries that ulp times the timestep, up to 999); ``add_noise`` and
``step`` within 1e-6 of their max |value|; the UNet's output within
1e-5 of its max |value|, each gradient within 1e-4 of its own max |g|;
after AdamW (about ``lr x sign(g)``), each parameter within 1e-6 of
its own max |value| where every |g| entry is at least 1e-3 of the
parameter's max |g| (Adam divides by |g|).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import UNet2DConditionModel as JUNet
from paddle_tpu.models import UNetConfig as JConfig
from paddle_tpu.models.unet_diffusion import DDPMScheduler as JSched
from paddle_tpu.models.unet_diffusion import \
    timestep_embedding as j_embedding

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch.models import DDPMScheduler, UNet2DConditionModel
from paddle_tpu_torch.models import UNetConfig
from paddle_tpu_torch.models.unet_diffusion import timestep_embedding
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from _torch_zoo import numpy_init, one_torch_thread  # noqa: F401

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-6

#: (config fields, batch, context length, flash launches a forward, take
#: an AdamW step)
CONFIGS = {
    "tiny": (dict(), 2, 8, 0, True),
    "head-dim-64": (dict(sample_size=16, block_out_channels=(32, 128),
                         num_attention_heads=2, cross_attention_dim=48), 2,
                    77, 8, False),
}


def _share(got, want):
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _linear_names(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def test_timestep_embedding_matches_reference():
    t = np.array([0, 1, 17, 500, 999], np.int64)
    want = np.asarray(j_embedding(paddle.to_tensor(t), 320)._value)
    got = timestep_embedding(torch.from_numpy(t), 320)
    assert got.dtype == torch.float32 and got.shape == (5, 320)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=999 * 2.0 ** -23)


def test_scheduler_matches_reference():
    rng = np.random.default_rng(2)
    clean, noise, eps = (rng.normal(size=(3, 4, 5, 5)).astype(np.float32)
                         for _ in range(3))
    t = np.array([0, 250, 999], np.int64)
    js, ts = JSched(), DDPMScheduler()
    want = np.asarray(js.add_noise(paddle.to_tensor(clean),
                                   paddle.to_tensor(noise),
                                   paddle.to_tensor(t))._value)
    got = ts.add_noise(torch.from_numpy(clean), torch.from_numpy(noise),
                       torch.from_numpy(t))
    assert _share(got, want) <= PARAM_TOL
    for step in (0, 1, 640):
        want = np.asarray(js.step(paddle.to_tensor(eps), step,
                                  paddle.to_tensor(clean),
                                  key_noise=paddle.to_tensor(noise))._value)
        got = ts.step(torch.from_numpy(eps), step, torch.from_numpy(clean),
                      key_noise=torch.from_numpy(noise))
        assert _share(got, want) <= PARAM_TOL, step


def test_scheduler_sampled_step_within_the_port():
    ts = DDPMScheduler()
    x, eps = torch.randn(2, 4, 6, 6), torch.randn(2, 4, 6, 6)

    def draw(seed):
        return ts.step(eps, 300, x, generator=torch.Generator().manual_seed(
            seed))

    assert torch.equal(draw(5), draw(5)) and not torch.equal(draw(5),
                                                             draw(6))
    # t = 0 is the mean: no draw
    assert torch.equal(ts.step(eps, 0, x), ts.step(eps, 0, x, generator=None))
    with pytest.raises(ValueError, match="generator"):
        ts.step(eps, 3, x)


def _reference_step(jm, jo):
    """The reference's forward, MSE loss, backward and (with ``jo``) AdamW
    step as one program under its own ``jit.to_static(full_graph=True)``
    (its eager dispatch compiles one XLA program per op and shape):
    returns (output, loss, gradients by parameter name)."""
    names = [n for n, _ in jm.named_parameters()]
    params = [p for _, p in jm.named_parameters()]

    def step(x, t, ctx, target):
        out = jm(x, t, ctx)
        loss = ((out - target) ** 2).mean()
        loss.backward()
        grads = [p.grad for p in params]
        if jo is not None:
            jo.step()
        return out, loss, grads

    static = paddle.jit.to_static(step, full_graph=True)

    def run(*args):
        out, loss, grads = static(*args)
        return out, loss, {n: np.asarray(g._value)
                           for n, g in zip(names, grads)}
    return run


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_unet_train_step_matches_reference(case, monkeypatch):
    fields, b, ctx_len, flash_calls, adamw = CONFIGS[case]
    numpy_init(monkeypatch, seed=11)
    jm = JUNet(JConfig.tiny(**fields))
    tm = UNet2DConditionModel(UNetConfig.tiny(**fields), device="cpu")
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    load_paddle_tpu_state(tm, state)
    cfg = tm.config
    rng = np.random.default_rng(4)
    hw = cfg.sample_size
    x = rng.normal(size=(b, cfg.in_channels, hw, hw)).astype(np.float32)
    target = rng.normal(size=(b, cfg.out_channels, hw, hw)).astype(
        np.float32)
    t = rng.integers(0, 1000, (b,)).astype(np.int64)
    ctx = rng.normal(size=(b, ctx_len, cfg.cross_attention_dim)).astype(
        np.float32)

    calls = []
    real = fa.flash_attention_fused

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    import paddle_tpu_torch.nn.functional.attention as tattn
    monkeypatch.setattr(tattn, "flash_attention_fused", counting)

    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    jout, jl, jgrads = _reference_step(jm, jo if adamw else None)(
        paddle.to_tensor(x), paddle.to_tensor(t), paddle.to_tensor(ctx),
        paddle.to_tensor(target))
    tout = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert len(calls) == flash_calls
    if flash_calls:      # self-attention Sq = Sk, cross-attention Sk = 77
        assert {k[1] for _, k in calls} == {(hw // 2) ** 2, ctx_len}
    assert _share(tout, np.asarray(jout._value)) <= OUT_TOL

    tl = ((tout - torch.from_numpy(target)) ** 2).mean()
    assert abs(float(jl) - tl.item()) <= OUT_TOL * float(jl)
    tl.backward()
    linear = _linear_names(tm)
    jgrads = {n: g.T if n in linear else g for n, g in jgrads.items()}
    worst = max((_share(p.grad, jgrads[n]), n)
                for n, p in tm.named_parameters())
    assert worst[0] <= GRAD_TOL, worst
    if not adamw:
        return
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    to.step()
    for n, p in tm.named_parameters():
        want = np.asarray(jm.state_dict()[n]._value)
        want = want.T if n in linear else want
        g = np.abs(jgrads[n])
        keep = g >= 1e-3 * g.max()
        err = np.abs(p.detach().numpy() - want)[keep]
        assert err.size == 0 or err.max() <= PARAM_TOL * np.abs(want).max(), n
