"""The port's remaining losses (paddle_tpu_torch/nn/functional/
extra_loss.py, all 13 functions) against the reference's
(paddle_tpu/nn/functional/extra_loss.py) on the CPU, from the same numpy
inputs, fp32, every ``reduction``.

``CASES``: every output within 1e-5 of its own max |value| (absolute
below 1), and the gradient of ``sum(out * w)`` (``w`` fixed random
weights; over every output of a tuple) for each float input the case
lists, within 1e-4 of that gradient's max |g| (absolute below 1).
``multi_margin_loss`` reads its input's values in the reference (no
gradient there), so its gradient is held against ``jax.grad`` of the
reference's formula. ``ctc_loss``'s ``norm_by_times`` is held in value
(unchanged) and in gradient (each sample's divided by its input length)
separately. ``class_center_sample`` draws from the port's own generator
and is held within the port.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.nn import functional as TF

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _f(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _i(*values):
    return np.asarray(values, np.int64)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _conv(a, make):
    """numpy arrays (in lists and tuples too) -> ``make(array)``; other
    values as they are."""
    if isinstance(a, np.ndarray):
        return make(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_conv(v, make) for v in a)
    return a


def run_case(fn, inputs, kw, grads=(0,), seed=0):
    """Both packages' ``fn`` on ``inputs`` (numpy) and ``kw``: outputs
    and the gradients of the inputs at ``grads``. Returns the port's
    inputs and outputs."""
    j_in = [_conv(a, lambda v, i=i: paddle.to_tensor(
        v, stop_gradient=i not in grads)) for i, a in enumerate(inputs)]
    t_in = [_conv(a, lambda v, i=i: torch.from_numpy(v).requires_grad_(
        i in grads)) for i, a in enumerate(inputs)]
    kw_j = {k: _conv(v, paddle.to_tensor) for k, v in kw.items()}
    kw_t = {k: _conv(v, torch.from_numpy) for k, v in kw.items()}
    j_out = _outs(getattr(JF, fn)(*j_in, **kw_j))
    t_out = _outs(getattr(TF, fn)(*t_in, **kw_t))
    ws = []
    rng = np.random.default_rng(seed)
    for k, (jo, to) in enumerate(zip(j_out, t_out)):
        want = np.asarray(jo._value)
        _close(to.detach().numpy(), want, OUT_TOL, f"{fn} output {k}")
        ws.append(rng.normal(size=want.shape).astype(np.float32))
    if grads:
        sum(((jo * paddle.to_tensor(w)).sum()
             for jo, w in zip(j_out, ws)), paddle.to_tensor(0.0)).backward()
        sum((to * torch.from_numpy(w)).sum()
            for to, w in zip(t_out, ws)).backward()
        for i in grads:
            _close(t_in[i].grad.numpy(), np.asarray(j_in[i].grad._value),
                   GRAD_TOL, f"{fn} gradient {i}")
    return t_in, t_out


def _ctc(r, reduction="mean", lens=(7, 5, 6), lab_lens=(3, 0, 2)):
    labels = r.integers(1, 5, (3, 3))
    labels[1, 1] = labels[1, 0]                  # a repeated label
    return ([_f(r, 7, 3, 5), labels, _i(*lens), _i(*lab_lens)],
            dict(reduction=reduction))


def _rnnt(r, lam, reduction="mean"):
    return ([_f(r, 2, 5, 4, 6), r.integers(1, 6, (2, 3)), _i(5, 3),
             _i(3, 1)], dict(fastemit_lambda=lam, reduction=reduction))


def _hsig(r, bias, n_cls=7):
    args = [_f(r, 6, 4), r.integers(0, n_cls, (6, 1)), n_cls,
            _f(r, n_cls - 1, 4)]
    if bias:
        args.append(_f(r, n_cls - 1, 1))
    return args, {}


def _hsig_custom(r):
    table = np.array([[0, 1, 3], [0, 2, -1], [0, 1, 4], [0, 2, 5]])
    code = r.integers(0, 2, table.shape)
    return ([_f(r, 4, 5), _i(0, 1, 2, 3), 6, _f(r, 6, 5), _f(r, 6, 1),
             table, code], {})


def _adaptive(r, bias):
    x, lab = _f(r, 9, 6), r.integers(0, 12, (9,))
    head = _f(r, 6, 4 + 2)                        # shortlist 4, 2 clusters
    args = [x, lab, head, [(_f(r, 6, 3), _f(r, 3, 4)),
                           (_f(r, 6, 2), _f(r, 2, 4))], [4, 8, 12]]
    return args, (dict(head_bias=_f(r, 6)) if bias else {})


#: (id, function, make(rng) -> (inputs, kwargs), float inputs with a
#: gradient compared)
CASES = [
    *[(f"ctc_{red}", "ctc_loss", lambda r, red=red: _ctc(r, red), (0,))
      for red in ("mean", "sum", "none")],
    ("ctc_blank_last", "ctc_loss",
     lambda r: (_ctc(r)[0], dict(blank=4, reduction="none")), (0,)),
    *[(f"rnnt_{lam}_{red}", "rnnt_loss",
       lambda r, lam=lam, red=red: _rnnt(r, lam, red), (0,))
      for lam in (0.0, 0.001) for red in ("mean", "sum", "none")],
    ("hsigmoid_default", "hsigmoid_loss", lambda r: _hsig(r, False), (0, 3)),
    ("hsigmoid_default_bias", "hsigmoid_loss", lambda r: _hsig(r, True),
     (0, 3, 4)),
    ("hsigmoid_two_classes", "hsigmoid_loss",
     lambda r: _hsig(r, True, n_cls=2), (0, 3, 4)),
    ("hsigmoid_custom", "hsigmoid_loss", _hsig_custom, (0, 3, 4)),
    *[(f"poisson_{log}_{full}_{red}", "poisson_nll_loss",
       lambda r, log=log, full=full, red=red: (
           [_f(r, 5, 4) if log else _f(r, 5, 4, lo=0.1, hi=3.0),
            _f(r, 5, 4, lo=0.0, hi=4.0)],
           dict(log_input=log, full=full, reduction=red)), (0,))
      for log, full, red in ((True, False, "mean"), (False, True, "sum"),
                             (True, True, "none"))],
    *[(f"gaussian_{full}_{red}", "gaussian_nll_loss",
       lambda r, full=full, red=red: (
           [_f(r, 6, 3), _f(r, 6, 3), _f(r, 6, 3, lo=1e-7, hi=2.0)],
           dict(full=full, reduction=red)), (0, 1, 2))
      for full, red in ((False, "mean"), (True, "sum"), (False, "none"))],
    *[(f"triplet_{swap}_{red}", "triplet_margin_with_distance_loss",
       lambda r, swap=swap, red=red: (
           [_f(r, 5, 6), _f(r, 5, 6), _f(r, 5, 6)],
           dict(swap=swap, margin=2.0, reduction=red)), (0, 1, 2))
      for swap, red in ((False, "mean"), (True, "sum"), (True, "none"))],
    ("dice_2d", "dice_loss",
     lambda r: ([TF.softmax(torch.from_numpy(_f(r, 6, 4))).numpy(),
                 r.integers(0, 4, (6, 1))], {}), (0,)),
    ("dice_3d", "dice_loss",
     lambda r: ([TF.softmax(torch.from_numpy(_f(r, 2, 5, 3))).numpy(),
                 r.integers(0, 3, (2, 5, 1))], dict(epsilon=1e-3)), (0,)),
    *[(f"pairwise_p{p}_{keep}", "pairwise_distance",
       lambda r, p=p, keep=keep: ([_f(r, 4, 7), _f(r, 4, 7)],
                                  dict(p=p, keepdim=keep)), (0, 1))
      for p, keep in ((2.0, False), (1.0, True), (3.0, False),
                      (float("inf"), False))],
    *[(f"margin_ce_{red}_{sm}", "margin_cross_entropy",
       lambda r, red=red, sm=sm: (
           [np.tanh(_f(r, 6, 8)), r.integers(0, 8, (6, 1))],
           dict(reduction=red, return_softmax=sm, scale=8.0)), (0,))
      for red, sm in (("mean", False), ("sum", True), ("none", True))],
    ("margin_ce_margins", "margin_cross_entropy",
     lambda r: ([np.tanh(_f(r, 6, 8)), r.integers(0, 8, (6,))],
                dict(margin1=1.2, margin2=0.2, margin3=0.1, scale=4.0)),
     (0,)),
    ("adaptive_lsm", "adaptive_log_softmax_with_loss",
     lambda r: _adaptive(r, False), (0, 2)),
    ("adaptive_lsm_bias", "adaptive_log_softmax_with_loss",
     lambda r: _adaptive(r, True), (0, 2)),
    ("sequence_mask", "sequence_mask",
     lambda r: ([_i(3, 0, 5, 1)], {}), ()),
    ("sequence_mask_maxlen_2d", "sequence_mask",
     lambda r: ([_i(3, 0, 5, 1).reshape(2, 2)], dict(maxlen=7,
                                                    dtype="float32")), ()),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loss_matches_reference(case):
    _, fn, make, grads = case
    inputs, kw = make(np.random.default_rng(len(case[0])))
    run_case(fn, inputs, kw, grads)


def test_adaptive_softmax_tail_weights_get_gradients():
    """The cluster weights (a list of pairs) against the reference's."""
    inputs, kw = _adaptive(np.random.default_rng(2), True)
    j_tails = [tuple(paddle.to_tensor(a, stop_gradient=False) for a in pair)
               for pair in inputs[3]]
    t_tails = [tuple(torch.from_numpy(a).requires_grad_() for a in pair)
               for pair in inputs[3]]
    args = [inputs[0], inputs[1], inputs[2]]
    _, jl = JF.adaptive_log_softmax_with_loss(
        *map(paddle.to_tensor, args), j_tails, inputs[4],
        head_bias=paddle.to_tensor(kw["head_bias"]))
    _, tl = TF.adaptive_log_softmax_with_loss(
        *map(torch.from_numpy, args), t_tails, inputs[4],
        head_bias=torch.from_numpy(kw["head_bias"]))
    jl.backward()
    tl.backward()
    for jp, tp in zip(j_tails, t_tails):
        for ja, ta in zip(jp, tp):
            _close(ta.grad.numpy(), np.asarray(ja.grad._value), GRAD_TOL,
                   "tail weight")


@pytest.mark.parametrize("p, weighted, red", [
    (1, False, "mean"), (2, True, "sum"), (1, True, "none")])
def test_multi_margin_loss_matches_reference(p, weighted, red):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(p)
    x = _f(rng, 6, 5)
    lab = rng.integers(0, 5, (6,))
    w = _f(rng, 5, lo=0.5, hi=2.0) if weighted else None
    kw = dict(p=p, margin=1.5, reduction=red)
    jl = JF.multi_margin_loss(paddle.to_tensor(x), paddle.to_tensor(lab),
                              weight=None if w is None else
                              paddle.to_tensor(w), **kw)
    tx = torch.from_numpy(x).requires_grad_()
    tl = TF.multi_margin_loss(tx, torch.from_numpy(lab),
                              weight=None if w is None else
                              torch.from_numpy(w), **kw)
    _close(tl.detach().numpy(), np.asarray(jl._value), OUT_TOL, "loss")

    def formula(xv):
        n, c = xv.shape
        m = jnp.maximum(0.0, 1.5 - xv[jnp.arange(n), lab][:, None] + xv) ** p
        if w is not None:
            m = m * w[lab][:, None]
        m = m.at[jnp.arange(n), lab].set(0.0)
        loss = jnp.sum(m, axis=1) / c
        return {"mean": loss.mean(), "sum": loss.sum(),
                "none": loss}[red]

    gw = _f(rng, *np.shape(jl._value))
    tl.backward(torch.from_numpy(gw))
    _, vjp = jax.vjp(formula, jnp.asarray(x))
    _close(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(gw))[0]), GRAD_TOL,
           "grad")


def test_ctc_norm_by_times_scales_only_the_gradient():
    inputs, kw = _ctc(np.random.default_rng(3), "none")
    t_plain = torch.from_numpy(inputs[0]).requires_grad_()
    t_norm = torch.from_numpy(inputs[0]).requires_grad_()
    rest = [torch.from_numpy(a) for a in inputs[1:]]
    plain = TF.ctc_loss(t_plain, *rest, reduction="none")
    normed = TF.ctc_loss(t_norm, *rest, reduction="none",
                         norm_by_times=True)
    torch.testing.assert_close(normed, plain, rtol=0, atol=0)
    plain.sum().backward()
    normed.sum().backward()
    lens = torch.tensor([7.0, 5.0, 6.0])[None, :, None]
    torch.testing.assert_close(t_norm.grad, t_plain.grad / lens, rtol=1e-6,
                               atol=1e-7)
    # and against the reference with the mean reduction
    run_case("ctc_loss", inputs, dict(norm_by_times=True), (0,))


def test_ctc_past_the_input_length_has_no_gradient():
    inputs, _ = _ctc(np.random.default_rng(4), "sum")
    x = torch.from_numpy(inputs[0]).requires_grad_()
    TF.ctc_loss(x, *map(torch.from_numpy, inputs[1:]),
                reduction="sum").backward()
    assert float(x.grad[5:, 1].abs().max()) == 0.0    # sample 1: length 5
    assert float(x.grad[6:, 2].abs().max()) == 0.0


def test_hsigmoid_custom_needs_both_tables():
    x = torch.randn(2, 3)
    with pytest.raises(ValueError, match="BOTH"):
        TF.hsigmoid_loss(x, torch.zeros(2, dtype=torch.long), 4,
                         torch.randn(3, 3), path_table=torch.zeros(2, 2))


def test_class_center_sample_within_the_port():
    lab = torch.tensor([3, 17, 3, 40, 8, 17, 99])
    g = torch.Generator().manual_seed(0)
    remap, sampled = TF.class_center_sample(lab, 100, 20, generator=g)
    assert sampled.numel() == 20
    assert torch.equal(sampled, torch.sort(sampled).values)
    assert len(set(sampled.tolist())) == 20
    assert set(lab.tolist()) <= set(sampled.tolist())      # positives kept
    assert torch.equal(sampled[remap], lab)                # remap consistent
    again = TF.class_center_sample(lab, 100, 20,
                                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(again[1], sampled)
    other = TF.class_center_sample(lab, 100, 20,
                                   generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other[1], sampled)
    # as many positives as samples: those, sorted, and no draw needed
    remap, sampled = TF.class_center_sample(lab, 100, 3)
    assert sampled.tolist() == [3, 8, 17, 40, 99]
    assert torch.equal(sampled[remap], lab)
    with pytest.raises(ValueError, match="generator"):
        TF.class_center_sample(lab, 100, 20)


def test_class_center_sample_matches_reference_when_all_positive():
    lab = np.array([5, 2, 9, 2, 0])
    jr, js = JF.class_center_sample(paddle.to_tensor(lab), 12, 4)
    tr, ts = TF.class_center_sample(torch.from_numpy(lab), 12, 4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js._value))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr._value))


def test_rnnt_long_lattice_runs_in_float64():
    """``rnnt_loss`` at a real length, [2, 200, 41, 32] with 40 labels:
    the reference's lattice runs in float64 (jax's x64) and returns
    float64; an fp32 lattice parts from it by about 2e-4 of max |g| here.
    The loss within ``OUT_TOL`` and the gradient of the summed loss
    within ``GRAD_TOL`` of max |g|; both dtypes float64."""
    r = np.random.default_rng(11)
    x = _f(r, 2, 200, 41, 32)
    inputs = [x, r.integers(1, 32, (2, 40)), _i(200, 200), _i(40, 40)]
    _, (out,) = run_case("rnnt_loss", inputs, dict(reduction="sum"))
    ref = JF.rnnt_loss(*[paddle.to_tensor(a) for a in inputs],
                       reduction="sum")
    assert str(ref._value.dtype) == "float64"
    assert out.dtype == torch.float64


def test_ctc_infeasible_sample_gradient_follows_the_reference():
    """A label that needs more frames than the sample has (T 3, labels
    ``[1, 1, 1, 1]``): its loss is the 1e30 sentinel in both packages,
    and its gradient runs through ``logaddexp`` of two equal sentinels,
    where jax gives each input the whole gradient (``exp(x - out)``) and
    torch's own rule half. Per sample, the gradient of the summed loss:
    the infeasible one within ``GRAD_TOL`` of its max |g|, the feasible
    one beside it within 1e-6 of its max |g|; the loss float32 in
    both."""
    r = np.random.default_rng(5)
    logits = _f(r, 3, 2, 5)
    labels = np.array([[1, 1, 1, 1], [2, 3, 0, 0]], np.int64)
    lens, lab_lens = _i(3, 3), _i(4, 2)
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.ctc_loss(jx, paddle.to_tensor(labels), paddle.to_tensor(lens),
                     paddle.to_tensor(lab_lens), reduction="none")
    jl.sum().backward()
    tx = torch.from_numpy(logits).requires_grad_()
    tl = TF.ctc_loss(tx, torch.from_numpy(labels), torch.from_numpy(lens),
                     torch.from_numpy(lab_lens), reduction="none")
    tl.sum().backward()
    assert str(jl._value.dtype) == "float32" and tl.dtype == torch.float32
    want_loss = np.asarray(jl._value)
    assert want_loss[0] == tl[0].item() == np.float32(1e30)
    _close(tl[1].item(), want_loss[1], OUT_TOL, "feasible loss")
    want = np.asarray(jx.grad._value)
    got = tx.grad.numpy()
    for b, tol in ((0, GRAD_TOL), (1, 1e-6)):
        scale = float(np.abs(want[:, b]).max())
        err = float(np.abs(got[:, b] - want[:, b]).max())
        assert err <= tol * scale, (b, err, tol * scale)
