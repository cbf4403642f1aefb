"""The port's training losses (paddle_tpu_torch/nn/functional/loss.py
``cross_entropy`` and incubate/nn/functional/fused_linear_ce.py
``fused_linear_cross_entropy``) against the reference package's
(paddle_tpu/nn/functional/loss.py, paddle_tpu/incubate/nn/functional/
fused_linear_ce.py), on the CPU: the loss and the gradients of its
inputs, from the same numpy inputs, with ``ignore_index`` entries and a
token count that is not a multiple of the chunk.

fp32 throughout. Tolerances: loss 2e-6 absolute (a mean of ~5 over up
to 35 tokens, log-sum-exps summed in another order); gradients 1e-6
absolute (softmax minus one-hot over the valid count, entries < 0.1).
The reference's lm-head weight is [H, V] and the port's [V, H]; the
port's gradient is compared transposed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import \
    fused_linear_cross_entropy as j_fused_ce
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.incubate.nn.functional import \
    fused_linear_cross_entropy as t_fused_ce
from paddle_tpu_torch.nn import functional as TF

LOSS_TOL = 2e-6
GRAD_TOL = 1e-6


def _labels(rng, t, v, n_ignored):
    labels = rng.integers(0, v, (t,))
    labels[rng.choice(t, n_ignored, replace=False)] = -100
    return labels


@pytest.mark.parametrize("n_ignored", [0, 5])
def test_cross_entropy_matches_reference(n_ignored):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(23, 40)).astype(np.float32)
    labels = _labels(rng, 23, 40, n_ignored)
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(labels), ignore_index=-100)
    jl.backward()
    tx = torch.from_numpy(logits).requires_grad_()
    tl = TF.cross_entropy(tx, torch.from_numpy(labels), ignore_index=-100)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._value),
                               rtol=0, atol=GRAD_TOL)


def test_cross_entropy_all_ignored_and_unported_options():
    logits = torch.randn(6, 9, generator=torch.Generator().manual_seed(1))
    labels = torch.tensor([1, -100, 3, 8, -100, 0])
    # every label ignored: the mean divides by max(count, 1)
    none = torch.full((6,), -100)
    assert float(TF.cross_entropy(logits, none)) == 0.0
    for kw in (dict(label_smoothing=0.1), dict(reduction="sum"),
               dict(soft_label=True)):
        with pytest.raises(NotImplementedError):
            TF.cross_entropy(logits, labels, **kw)


@pytest.mark.parametrize("t, chunk, n_ignored", [
    (35, 16, 6),      # three chunks, the last padded by 13
    (32, 32, 0),      # one exact chunk
    (20, 64, 20),     # every token ignored
])
def test_fused_linear_ce_matches_reference(t, chunk, n_ignored):
    rng = np.random.default_rng(t)
    h, v = 24, 50
    hidden = rng.normal(size=(t, h)).astype(np.float32)
    weight = (0.2 * rng.normal(size=(h, v))).astype(np.float32)   # [H, V]
    labels = _labels(rng, t, v, n_ignored)
    jh = paddle.to_tensor(hidden, stop_gradient=False)
    jw = paddle.to_tensor(weight, stop_gradient=False)
    jl = j_fused_ce(jh, jw, paddle.to_tensor(labels), chunk_size=chunk)
    jl.backward()
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(weight.T.copy()).requires_grad_()       # [V, H]
    tl = t_fused_ce(th, tw, torch.from_numpy(labels), chunk_size=chunk)
    tl.backward()
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh.grad._value),
                               rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jw.grad._value),
                               rtol=0, atol=GRAD_TOL)


def test_fused_equals_unfused_loss():
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy(rng.normal(size=(30, 16)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    labels = torch.from_numpy(_labels(rng, 30, 40, 4))
    fused = t_fused_ce(hidden, weight, labels, chunk_size=7)
    plain = TF.cross_entropy(hidden @ weight.t(), labels)
    torch.testing.assert_close(fused, plain, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="labels"):
        t_fused_ce(hidden, weight, labels[:5])
