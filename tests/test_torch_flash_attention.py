"""The port's flash-attention forward (paddle_tpu_torch/ops/cuda/
flash_attention.py) against the reference package's Pallas kernel
(paddle_tpu/ops/pallas/flash_attention.py::_flash_fwd_bhsd), on the CPU;
the backward is held in test_torch_flash_backward.py.

The reference runs its kernel under the Pallas interpreter here (as its
own tests do off TPU); the port runs its plain version, which is what a
CPU tensor takes. Same numpy inputs, fp32. Tolerances: out 2e-6 and
lse 2e-6 absolute (one fp32 online softmax tile by tile vs one dense
softmax: only the order of the sums differs); gradients 2e-5 absolute
(as in test_torch_flash_backward.py). The dropout keep mask is compared
bit for bit. The CUDA kernel is held against the same plain version on
the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention as jfa

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

TOL = 2e-6
GRAD_TOL = 2e-5


def _inputs(seed, b, h, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


def _both(q, k, v, *, causal, bias=None, seed=None, rate=0.0):
    scale = q.shape[-1] ** -0.5
    j_out, j_lse = jfa._flash_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if seed is None else jnp.asarray([seed], jnp.int32),
        None if bias is None else jnp.asarray(bias),
        causal=causal, scale=scale, dropout_rate=rate)
    t_out, t_lse = tfa._flash_fwd_bhsd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if seed is None else torch.tensor([seed], dtype=torch.int32),
        None if bias is None else torch.from_numpy(bias),
        causal=causal, scale=scale, dropout_rate=rate)
    return (np.asarray(j_out), np.asarray(j_lse)), (t_out.numpy(),
                                                    t_lse.numpy())


def _close(jax_pair, torch_pair):
    (jo, jl), (to, tl) = jax_pair, torch_pair
    np.testing.assert_allclose(to, jo, rtol=0, atol=TOL)
    np.testing.assert_array_equal(np.isinf(tl), np.isinf(jl))
    np.testing.assert_allclose(tl[np.isfinite(tl)], jl[np.isfinite(jl)],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("causal, h, hkv, sq, sk", [
    (True, 4, 4, 32, 32),        # square causal
    (False, 4, 4, 16, 48),       # Sq != Sk, three k tiles
    (True, 4, 2, 16, 48),        # bottom-right causal offset, GQA 2
    (True, 4, 1, 32, 32),        # GQA 4 (MQA)
])
def test_forward_matches_pallas_kernel(causal, h, hkv, sq, sk):
    q, k, v = _inputs(1, 2, h, hkv, sq, sk, 16)
    _close(*_both(q, k, v, causal=causal))


def test_fully_masked_rows_give_zero_and_neg_inf_lse():
    # causal with Sq > Sk: query i sees keys <= i - 32, so rows 0..31 see
    # nothing
    q, k, v = _inputs(2, 1, 2, 2, 48, 16, 16)
    jax_pair, torch_pair = _both(q, k, v, causal=True)
    _close(jax_pair, torch_pair)
    out, lse = torch_pair
    assert np.isneginf(lse[:, :, :32]).all()
    assert (out[:, :, :32] == 0).all()


@pytest.mark.parametrize("bias_batch", [1, 2])
def test_key_bias(bias_batch):
    q, k, v = _inputs(3, 2, 4, 2, 16, 32, 16)
    rng = np.random.default_rng(4)
    bias = rng.normal(size=(bias_batch, 32)).astype(np.float32)
    bias[:, ::5] = -1e9
    if bias_batch == 2:
        bias[0] = -np.inf             # every key of batch 0 masked
    jax_pair, torch_pair = _both(q, k, v, causal=False, bias=bias)
    _close(jax_pair, torch_pair)
    if bias_batch == 2:
        assert np.isneginf(torch_pair[1][0]).all()


def test_dropout_forward_matches():
    q, k, v = _inputs(5, 2, 2, 2, 32, 32, 16)
    _close(*_both(q, k, v, causal=True, seed=1234, rate=0.25))


@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 987654321])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_bit_identical(seed, rate):
    for bh in (0, 5, 1023):
        for i, j in ((0, 0), (3, 7), (100, 2)):
            want = np.asarray(jfa._dropout_keep(
                jnp.int32(seed), jnp.int32(bh), jnp.int32(i), jnp.int32(j),
                16, 32, rate))
            got = tfa._dropout_keep(torch.tensor(seed, dtype=torch.int32),
                                    bh, i, j, 16, 32, rate).numpy()
            np.testing.assert_array_equal(got, want)


def test_bshd_layout_wrapper_matches():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    jo, jl = jfa.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True)
    to, tl = tfa.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=True)
    _close((np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy()))


def test_cpu_never_launches_and_backward_waits():
    # the backward no longer waits: on CPU tensors it runs the plain
    # version, launches nothing, and gives autograd's gradients of the
    # plain forward
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(7, 1, 2, 2, 8, 8, 64))
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    before = (tfa.launches, tfa.bwd_launches)
    out = tfa.flash_attention_fused(qs, ks, vs, causal=True)
    out.sum().backward()
    assert (tfa.launches, tfa.bwd_launches) == before
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ref, _ = tfa._flash_fwd_reference(q, k, v, causal=True, scale=0.125)
    ref.sum().backward()
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=GRAD_TOL)
    with pytest.raises(ValueError, match="Generator"):
        tfa.flash_attention_fused(qs, ks, vs, dropout_p=0.1)
    with pytest.raises(ValueError, match="key_bias"):
        tfa._flash_fwd_bhsd(q, k, v, key_bias=torch.zeros(3, 8),
                            causal=False, scale=1.0)
