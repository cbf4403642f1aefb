"""The port's flash-attention backward (paddle_tpu_torch/ops/cuda/
flash_attention.py ``_flash_bwd_bhsd`` and the autograd function around
the kernels) against the reference package's Pallas backward kernels
(paddle_tpu/ops/pallas/flash_attention.py::_flash_bwd_bhsd), on the CPU.

The reference runs its kernels under the Pallas interpreter here (as its
own tests do off TPU); the port runs its plain version, which is what a
CPU tensor takes. Both start from the same out and lse, so only the
backward is compared. Same numpy inputs, fp32. Tolerance:
dq, dk, dv 2e-5 absolute on gradients of magnitude < 20 (sums over up
to 48 keys or rows in another order, and a GQA group sum the reference
takes per head after its own cast). The CUDA kernels are held against
the same plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention as jfa

from paddle_tpu_torch.core.flags import flags_scope
from paddle_tpu_torch.core.generator import draw_seed, make_generator
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

TOL = 2e-6
GRAD_TOL = 2e-5


def _inputs(seed, b, h, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


def _bwd_both(q, k, v, do, *, causal, bias=None, seed=None, rate=0.0):
    """dq, dk, dv of the reference's interpreted backward kernels and of
    the port's plain version, both from the same out and lse (the port's
    forward, held to the reference's in test_torch_flash_attention.py),
    so only the backward is compared."""
    kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, dropout_rate=rate)
    t = torch.from_numpy
    tseed = None if seed is None else torch.tensor([seed], dtype=torch.int32)
    tbias = None if bias is None else t(bias)
    tq, tk, tv = t(q), t(k), t(v)
    out, lse = tfa._flash_fwd_bhsd(tq, tk, tv, tseed, tbias, **kw)
    got = tfa._flash_bwd_bhsd(tq, tk, tv, out, lse, t(do), tseed, tbias,
                              **kw)
    want = jfa._flash_bwd_bhsd(
        *(jnp.asarray(a) for a in (q, k, v, out.numpy(), lse.numpy(), do)),
        None if seed is None else jnp.asarray([seed], jnp.int32),
        None if bias is None else jnp.asarray(bias), **kw)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def _grads_close(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal, h, hkv, sq, sk", [
    (True, 4, 4, 32, 32),        # square causal
    (False, 4, 4, 16, 48),       # Sq != Sk, three k tiles
    (True, 4, 2, 16, 48),        # bottom-right causal offset, GQA 2
    (True, 4, 1, 32, 32),        # GQA 4 (MQA)
])
def test_backward_matches_pallas_kernels(causal, h, hkv, sq, sk):
    q, k, v = _inputs(11, 2, h, hkv, sq, sk, 16)
    do = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    _grads_close(*_bwd_both(q, k, v, do, causal=causal))


@pytest.mark.parametrize("bias_batch", [1, 2])
def test_backward_key_bias(bias_batch):
    q, k, v = _inputs(13, 2, 4, 2, 16, 32, 16)
    rng = np.random.default_rng(14)
    do = rng.normal(size=q.shape).astype(np.float32)
    bias = rng.normal(size=(bias_batch, 32)).astype(np.float32)
    bias[:, ::5] = -1e9
    if bias_batch == 2:
        bias[0] = -np.inf             # every key of batch 0 masked
    got, want = _bwd_both(q, k, v, do, causal=False, bias=bias)
    _grads_close(got, want)
    if bias_batch == 2:
        assert all((g[0] == 0).all() for g in got)


def test_backward_dropout_same_bits():
    q, k, v = _inputs(15, 2, 4, 2, 32, 32, 16)
    do = np.random.default_rng(16).normal(size=q.shape).astype(np.float32)
    _grads_close(*_bwd_both(q, k, v, do, causal=True, seed=4321, rate=0.25))


def test_backward_fully_masked_rows_are_zero():
    # causal Sq 48 > Sk 16: rows 0..31 see no key (lse -inf)
    q, k, v = _inputs(17, 1, 2, 2, 48, 16, 16)
    do = np.random.default_rng(18).normal(size=q.shape).astype(np.float32)
    got, want = _bwd_both(q, k, v, do, causal=True)
    _grads_close(got, want)
    assert (got[0][:, :, :32] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_gradients_flash_route_vs_plain(masked):
    # scaled_dot_product_attention's flash route (D 64 passes the gate:
    # the autograd function over the plain kernel versions) against the
    # plain composition under autograd, GQA 4/2, [B, S, H, D]
    rng = np.random.default_rng(19)
    q = rng.normal(size=(2, 24, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 64)).astype(np.float32)
    mask = None
    if masked:
        m = np.zeros((2, 1, 1, 24), np.float32)
        m[1, ..., :7] = -1e9
        mask = torch.from_numpy(m)

    def grads(flash):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        with flags_scope(use_cuda_flash_attention=flash):
            out = TF.scaled_dot_product_attention(*ts, attn_mask=mask,
                                                  is_causal=not masked)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)
         ).sum().backward()
        return out.detach().numpy(), [t.grad.numpy() for t in ts]

    (fo, fg), (po, pg) = grads(True), grads(False)
    np.testing.assert_allclose(fo, po, rtol=0, atol=TOL)
    _grads_close(fg, pg)


def test_backward_reuses_the_forward_seed():
    # dropout through the autograd function: its gradients are autograd's
    # of the plain forward under the seed the forward drew, so the
    # backward regenerated the same keep mask (a second draw would not)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(20, 1, 2, 2, 32, 32, 64))
    gen = make_generator(5, "cpu")
    out = tfa.flash_attention_fused(*(t.transpose(1, 2) for t in (q, k, v)),
                                    causal=True, dropout_p=0.3,
                                    generator=gen)
    out.sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    seed = draw_seed(make_generator(5, "cpu"), "cpu")
    ref, _ = tfa._flash_fwd_reference(q, k, v, seed, causal=True,
                                      scale=0.125, dropout_rate=0.3)
    ref.transpose(1, 2).sum().backward()
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=GRAD_TOL)
