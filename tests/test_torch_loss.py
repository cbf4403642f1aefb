"""The port's losses (paddle_tpu_torch/nn/functional/loss.py, all 19
functions, and incubate/nn/functional/fused_linear_ce.py
``fused_linear_cross_entropy``) against the reference package's
(paddle_tpu/nn/functional/loss.py, paddle_tpu/incubate/nn/functional/
fused_linear_ce.py), on the CPU: the loss and the gradients of its
inputs, from the same numpy inputs, with ``ignore_index`` entries and a
token count that is not a multiple of the chunk; then one case per
function and option of the loss module (``LOSS_CASES``).

fp32 throughout. Tolerances: loss 2e-6 absolute (a mean of ~5 over up
to 35 tokens, log-sum-exps summed in another order); gradients 1e-6
absolute (softmax minus one-hot over the valid count, entries < 0.1).
In ``LOSS_CASES`` every output within 2e-6 of its own max |value| (or
2e-6 absolute below 1) and every input gradient within 1e-6 of its own
max |g| (or 1e-6 absolute below 1); NaN where the reference gives NaN.
The reference's lm-head weight is [H, V] and the port's [V, H]; the
port's gradient is compared transposed.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

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
    # every label ignored: the mean divides by max(count, 1)
    none = torch.full((6,), -100)
    assert float(TF.cross_entropy(logits, none)) == 0.0
    # the options this file held as unported now run, each equal to the
    # reference in LOSS_CASES; here only that they give the right shapes
    labels = torch.tensor([1, -100, 3, 8, -100, 0])
    assert TF.cross_entropy(logits, labels, label_smoothing=0.1).shape == ()
    assert TF.cross_entropy(logits, labels, reduction="none").shape == (6,)
    soft = torch.softmax(torch.randn(6, 9), -1)
    assert TF.cross_entropy(logits, soft, soft_label=True).shape == ()


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


def _f(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _probs(rng, *shape, axis=-1):
    x = np.exp(_f(rng, *shape))
    return (x / x.sum(axis, keepdims=True)).astype(np.float32)


def _hard(rng, n, c, n_ignored=0, shape=None):
    lab = rng.integers(0, c, (n,))
    lab[:n_ignored] = -100
    return lab.reshape(shape) if shape else lab


def _signs(rng, *shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


#: (id, function, make(rng) -> (inputs, kwargs)); the first input takes
#: a gradient, and so does any other float input listed in ``grads``
LOSS_CASES = [
    ("ce_sum_ignored", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5, 2)], dict(reduction="sum"))),
    ("ce_none_ignored", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5, 2)], dict(reduction="none"))),
    ("ce_label_n1", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5, shape=(8, 1))], {})),
    ("ce_weight_mean", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5)],
                dict(weight=_f(r, 5, lo=0.2, hi=2.0)))),
    ("ce_weight_sum", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5)],
                dict(weight=_f(r, 5, lo=0.2, hi=2.0), reduction="sum"))),
    ("ce_weight_ignored_is_nan", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5, 2)],
                dict(weight=_f(r, 5, lo=0.2, hi=2.0)))),
    ("ce_soft_mean", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _probs(r, 8, 5)], dict(soft_label=True))),
    ("ce_soft_none", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _probs(r, 8, 5)],
                dict(soft_label=True, reduction="none"))),
    ("ce_smoothing_hard", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5, 2)],
                dict(label_smoothing=0.1))),
    ("ce_smoothing_soft_sum", "cross_entropy",
     lambda r: ([_f(r, 8, 5), _probs(r, 8, 5)],
                dict(soft_label=True, label_smoothing=0.2,
                     reduction="sum"))),
    ("ce_no_softmax_hard", "cross_entropy",
     lambda r: ([_probs(r, 8, 5), _hard(r, 8, 5, 1)],
                dict(use_softmax=False))),
    ("ce_no_softmax_soft", "cross_entropy",
     lambda r: ([_probs(r, 8, 5), _probs(r, 8, 5)],
                dict(use_softmax=False, soft_label=True))),
    ("ce_axis1", "cross_entropy",
     lambda r: ([_f(r, 3, 5, 4), _hard(r, 12, 5, 2, shape=(3, 4))],
                dict(axis=1))),
    ("ce_axis1_label_n1_sum", "cross_entropy",
     lambda r: ([_f(r, 3, 5, 4), _hard(r, 12, 5, shape=(3, 1, 4))],
                dict(axis=1, reduction="sum"))),
    ("ce_axis1_soft", "cross_entropy",
     lambda r: ([_f(r, 3, 5, 4), _probs(r, 3, 5, 4, axis=1)],
                dict(axis=1, soft_label=True))),
    ("swce_hard", "softmax_with_cross_entropy",
     lambda r: ([_f(r, 8, 5), _hard(r, 8, 5, 2, shape=(8, 1))], {})),
    ("swce_soft_softmax", "softmax_with_cross_entropy",
     lambda r: ([_f(r, 8, 5), _probs(r, 8, 5)],
                dict(soft_label=True, return_softmax=True))),
    ("swce_axis0", "softmax_with_cross_entropy",
     lambda r: ([_f(r, 5, 6), _hard(r, 6, 5, shape=(1, 6))], dict(axis=0))),
    ("nll_mean_ignored", "nll_loss",
     lambda r: ([np.log(_probs(r, 8, 5)), _hard(r, 8, 5, 2)], {})),
    ("nll_sum", "nll_loss",
     lambda r: ([np.log(_probs(r, 8, 5)), _hard(r, 8, 5)],
                dict(reduction="sum"))),
    ("nll_weight", "nll_loss",
     lambda r: ([np.log(_probs(r, 8, 5)), _hard(r, 8, 5)],
                dict(weight=_f(r, 5, lo=0.2, hi=2.0)))),
    ("nll_4d_none", "nll_loss",
     lambda r: ([np.log(_probs(r, 2, 5, 3, 2, axis=1)),
                 _hard(r, 12, 5, 3, shape=(2, 3, 2))],
                dict(reduction="none"))),
    ("mse_mean", "mse_loss", lambda r: ([_f(r, 4, 6), _f(r, 4, 6)], {})),
    ("mse_none", "mse_loss",
     lambda r: ([_f(r, 4, 6), _f(r, 4, 6)], dict(reduction="none"))),
    ("square_error_cost", "square_error_cost",
     lambda r: ([_f(r, 4, 6), _f(r, 4, 6)], {})),
    ("l1_sum", "l1_loss",
     lambda r: ([_f(r, 4, 6), _f(r, 4, 6)], dict(reduction="sum"))),
    ("bce_weight", "binary_cross_entropy",
     lambda r: ([_f(r, 4, 6, lo=0.01, hi=0.99), _f(r, 4, 6, lo=0, hi=1)],
                dict(weight=_f(r, 6, lo=0.5, hi=1.5)))),
    ("bce_none", "binary_cross_entropy",
     lambda r: ([_f(r, 4, 6, lo=0.01, hi=0.99), _f(r, 4, 6, lo=0, hi=1)],
                dict(reduction="none"))),
    ("bce_logits", "binary_cross_entropy_with_logits",
     lambda r: ([3 * _f(r, 4, 6), _f(r, 4, 6, lo=0, hi=1)], {})),
    ("bce_logits_pos_weight", "binary_cross_entropy_with_logits",
     lambda r: ([3 * _f(r, 4, 6), _f(r, 4, 6, lo=0, hi=1)],
                dict(pos_weight=_f(r, 6, lo=0.5, hi=3.0),
                     weight=_f(r, 6, lo=0.5, hi=1.5), reduction="sum"))),
    ("kl_mean", "kl_div",
     lambda r: ([np.log(_probs(r, 4, 6)), _probs(r, 4, 6)], {})),
    ("kl_batchmean", "kl_div",
     lambda r: ([np.log(_probs(r, 4, 6)), _probs(r, 4, 6)],
                dict(reduction="batchmean"))),
    ("kl_log_target_sum", "kl_div",
     lambda r: ([np.log(_probs(r, 4, 6)), np.log(_probs(r, 4, 6))],
                dict(log_target=True, reduction="sum"))),
    ("smooth_l1", "smooth_l1_loss",
     lambda r: ([_f(r, 4, 6), _f(r, 4, 6)], {})),
    ("smooth_l1_delta", "smooth_l1_loss",
     lambda r: ([_f(r, 4, 6), _f(r, 4, 6)],
                dict(delta=0.5, reduction="none"))),
    ("margin_ranking", "margin_ranking_loss",
     lambda r: ([_f(r, 8), _f(r, 8), _signs(r, 8)], dict(margin=0.1))),
    ("focal_sum", "sigmoid_focal_loss",
     lambda r: ([2 * _f(r, 4, 6), (r.random((4, 6)) < 0.3).astype(
         np.float32)], {})),
    ("focal_normalizer_mean", "sigmoid_focal_loss",
     lambda r: ([2 * _f(r, 4, 6), (r.random((4, 6)) < 0.3).astype(
         np.float32)], dict(normalizer=np.float32(7.0), alpha=0.4,
                            gamma=1.5, reduction="mean"))),
    ("hinge_embedding", "hinge_embedding_loss",
     lambda r: ([_f(r, 4, 6), _signs(r, 4, 6)], dict(margin=0.5))),
    ("cosine_embedding", "cosine_embedding_loss",
     lambda r: ([_f(r, 6, 5), _f(r, 6, 5), _signs(r, 6)],
                dict(margin=0.2))),
    ("triplet_p2", "triplet_margin_loss",
     lambda r: ([_f(r, 6, 5), _f(r, 6, 5), _f(r, 6, 5)], {})),
    ("triplet_p1_swap_sum", "triplet_margin_loss",
     lambda r: ([_f(r, 6, 5), _f(r, 6, 5), _f(r, 6, 5)],
                dict(p=1.0, swap=True, margin=0.5, reduction="sum"))),
    ("soft_margin", "soft_margin_loss",
     lambda r: ([_f(r, 4, 6), _signs(r, 4, 6)], {})),
    ("multi_label_soft_margin", "multi_label_soft_margin_loss",
     lambda r: ([_f(r, 4, 6), (r.random((4, 6)) < 0.5).astype(np.float32)],
                dict(weight=_f(r, 6, lo=0.5, hi=1.5)))),
    ("log_loss", "log_loss",
     lambda r: ([_f(r, 4, 1, lo=0.01, hi=0.99), _f(r, 4, 1, lo=0, hi=1)],
                {})),
    ("npair", "npair_loss",
     lambda r: ([_f(r, 6, 5), _f(r, 6, 5), np.array([0, 1, 0, 2, 1, 3])],
                {})),
]


def _close(got, want, atol):
    """Within ``atol`` of ``want``'s own max |value| (absolute below 1);
    NaN where ``want`` is NaN."""
    scale = max(1.0, float(np.nanmax(np.abs(want))) if want.size and
                not np.isnan(want).all() else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_function_matches_reference(case):
    _, fn, make = case
    inputs, kw = make(np.random.default_rng(len(case[0])))
    j_in = [paddle.to_tensor(a, stop_gradient=i != 0)
            for i, a in enumerate(inputs)]
    t_in = [torch.from_numpy(np.asarray(a)) for a in inputs]
    t_in[0].requires_grad_()
    j_kw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    t_kw = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
            else v for k, v in kw.items()}
    j_out = getattr(JF, fn)(*j_in, **j_kw)
    t_out = getattr(TF, fn)(*t_in, **t_kw)
    if isinstance(t_out, tuple):        # (loss, softmax)
        _close(t_out[1].detach().numpy(), np.asarray(j_out[1]._value), 2e-6)
        j_out, t_out = j_out[0], t_out[0]
    want = np.asarray(j_out._value)
    assert tuple(t_out.shape) == want.shape and t_out.dtype == torch.float32
    _close(t_out.detach().numpy(), want, 2e-6)
    if np.isnan(want).any():
        return
    (j_out.sum() if j_out.ndim else j_out).backward()
    (t_out.sum() if t_out.ndim else t_out).backward()
    _close(t_in[0].grad.numpy(), np.asarray(j_in[0].grad._value), 1e-6)
