"""The port's varlen flash-attention backward (paddle_tpu_torch/ops/cuda/
flash_attention_varlen.py ``_vflash_bwd`` and the autograd function
behind ``flash_attn_unpadded``) against the reference package's Pallas
backward kernels (paddle_tpu/ops/pallas/flash_attention_varlen.py::
_vflash_bwd), on the CPU.

The reference runs its kernels under the Pallas interpreter here; the
port runs its plain version, which is what a CPU tensor takes. Both start
from the same out and lse (the port's forward, held to the reference's in
test_torch_flash_varlen.py), padded to the reference's [H, T_pad, D]
layout for it, so only the backward is compared. Same numpy inputs, fp32.
Tolerance: dq, dk, dv 2e-5 absolute on gradients of magnitude < 20 (sums
over up to 64 keys or rows in another order, and a GQA group sum the
reference takes per head after its own cast). Autograd through
``flash_attn_unpadded`` is also held against autograd of the port's plain
dense composition run segment by segment, within the same 2e-5.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import jax.numpy as jnp
from paddle_tpu.ops.pallas import flash_attention_varlen as jvf

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core.generator import draw_seed, make_generator
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import flash_attention_varlen as tvf

GRAD_TOL = 2e-5


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _pack(seed, tq, tk, h, hkv, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(tq, h, d)).astype(np.float32),
            rng.normal(size=(tk, hkv, d)).astype(np.float32),
            rng.normal(size=(tk, hkv, d)).astype(np.float32),
            rng.normal(size=(tq, h, d)).astype(np.float32))


def _htd(x, fill=0.0):
    """[T, H, D] (or lse [H, T]) -> the reference's layout, T padded to
    128."""
    if x.ndim == 2:
        pad = -x.shape[1] % 128
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, pad)),
                       constant_values=fill)
    return jnp.pad(jnp.swapaxes(jnp.asarray(x), 0, 1),
                   ((0, 0), (0, -x.shape[0] % 128), (0, 0)))


def _bwd_both(q, k, v, do, cu_q, cu_k, *, causal, seed=None, rate=0.0):
    kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, dropout_rate=rate)
    t = torch.from_numpy
    tseed = None if seed is None else torch.tensor([seed], dtype=torch.int32)
    args = (t(q), t(k), t(v), t(cu_q), t(cu_k))
    out, lse = tvf._vflash_fwd(*args, tseed, **kw)
    got = tvf._vflash_bwd(*args, out, lse, t(do), tseed, **kw)
    jdq, jdk, jdv = jvf._vflash_bwd(
        _htd(q), _htd(k), _htd(v), jnp.asarray(cu_q), jnp.asarray(cu_k),
        _htd(out.numpy()), _htd(lse.numpy(), -np.inf), _htd(do),
        None if seed is None else jnp.asarray([seed], jnp.int32),
        n_seqs=len(cu_q) - 1, **kw)
    want = [np.swapaxes(np.asarray(x), 0, 1)[:n]
            for x, n in ((jdq, q.shape[0]), (jdk, k.shape[0]),
                         (jdv, k.shape[0]))]
    return [x.numpy() for x in got], want


def _grads_close(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h, hkv", [(4, 4), (4, 2)])
def test_backward_matches_pallas_kernels(causal, h, hkv):
    cu = _cu([37, 1, 50, 12])
    q, k, v, do = _pack(21, int(cu[-1]), int(cu[-1]), h, hkv)
    _grads_close(*_bwd_both(q, k, v, do, cu, cu, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_backward_cross_lengths_and_empty_segments(causal):
    # len_k != len_q (the dk/dv rows under bottom-right causal), a
    # zero-length q segment, an empty key segment, rows past cu[-1]
    cu_q, cu_k = _cu([5, 9, 0, 3, 4]), _cu([8, 4, 6, 3, 0])
    q, k, v, do = _pack(22, int(cu_q[-1]) + 3, int(cu_k[-1]), 4, 2)
    got, want = _bwd_both(q, k, v, do, cu_q, cu_k, causal=causal)
    _grads_close(got, want)
    assert (got[0][17:] == 0).all()            # rows that see no key
    if causal:
        assert (got[0][5:10] == 0).all()


def test_backward_dropout_same_bits():
    cu = _cu([20, 13, 31])
    q, k, v, do = _pack(23, int(cu[-1]), int(cu[-1]), 4, 2)
    _grads_close(*_bwd_both(q, k, v, do, cu, cu, causal=True, seed=4321,
                            rate=0.25))


def _segment_autograd(q, k, v, w, lens, causal, scale):
    """Gradients of sum(out * w) through the port's plain dense forward
    (``_flash_fwd_reference``), one segment at a time."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    total, start = 0.0, 0
    for n in lens:
        seg = [t[start:start + n].transpose(0, 1)[None] for t in ts]
        out, _ = tfa._flash_fwd_reference(*seg, causal=causal, scale=scale)
        total = total + (out[0].transpose(0, 1)
                         * torch.from_numpy(w[start:start + n])).sum()
        start += n
    total.backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_through_flash_attn_unpadded(causal):
    lens = [9, 1, 23, 15]
    cu = torch.from_numpy(_cu(lens))
    q, k, v, w = _pack(24, sum(lens), sum(lens), 4, 2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, _ = TF.flash_attn_unpadded(*ts, cu, cu, 23, 23, 0.25, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    want = _segment_autograd(q, k, v, w, lens, causal, 0.25)
    _grads_close([t.grad.numpy() for t in ts], want)


def test_autograd_through_qkvpacked_reuses_the_seed():
    # dropout through the packed entry: qkv's gradient is autograd's of
    # the plain forward under the seed the forward drew from the generator
    # (the backward regenerated the same keep bits; a second draw would
    # not)
    cu = torch.from_numpy(_cu([12, 20]))
    qkv = torch.from_numpy(np.random.default_rng(25).normal(
        size=(32, 3, 2, 16)).astype(np.float32)).requires_grad_()
    out, _ = TF.flash_attn_varlen_qkvpacked(
        qkv, cu, cu, 20, 20, scale=0.25, dropout=0.3, causal=True,
        generator=make_generator(7, "cpu"))
    out.sum().backward()
    got = qkv.grad.clone()
    qkv.grad = None
    seed = draw_seed(make_generator(7, "cpu"), "cpu")
    ref, _ = tvf._vflash_fwd_reference(*torch.unbind(qkv, 1), cu, cu, seed,
                                       causal=True, scale=0.25,
                                       dropout_rate=0.3)
    ref.sum().backward()
    np.testing.assert_allclose(got.numpy(), qkv.grad.numpy(), rtol=0,
                               atol=GRAD_TOL)
