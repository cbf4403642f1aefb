"""The port's functional ops that GPT calls (paddle_tpu_torch/nn/functional:
``activation.py``, ``common.py``'s ``linear``/``dropout``/``embedding``
and ``norm.py``'s ``layer_norm``) against the reference package's, on the
CPU, from the same numpy inputs.

- ``ACT_CASES``: one case per activation and option (the 29 names
  ``paddle_tpu/nn/functional/__init__.py`` re-exports from
  ``ops/activation.py``, and ``tanh``), the output and the gradient of
  ``sum(out * w)`` for a fixed random ``w``. fp32: outputs within 1e-6 of
  their own max |value| (or 1e-6 absolute below 1), gradients likewise.
  ``rrelu`` in training and ``gumbel_softmax`` draw random numbers,
  which the port takes from an explicit ``torch.Generator``, so they are
  held within the port (reproducible from a seed, in range, rows summing
  to 1, one-hot when ``hard``).
- ``linear`` (paddle's ``[in, out]`` weight), ``embedding`` (the
  ``padding_idx`` row zero in the output and in the gradient, a negative
  ``padding_idx``, bf16 gradients summed in fp32 and rounded once, ids
  out of range) and ``layer_norm`` (fp32 within 1e-5; bf16 within one
  bf16 ulp of the reference, forward and gradients).
- ``dropout``: the deterministic cases against the reference (p 0, p 1,
  inference in both modes), and the masks within the port: one seed
  twice equal, the keep rate within 4 standard deviations of ``1 - p``,
  kept entries scaled by the mode, one mask per slice along ``axis``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.core.generator import GeneratorTape
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-6


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _x(shape=(3, 5, 8), seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _weight_for(shape):
    return np.random.default_rng(99).standard_normal(shape).astype(np.float32)


#: (function name, keyword arguments, input maker); each case checks the
#: output and the input's gradient against the reference
ACT_CASES = [
    ("relu", {}), ("relu6", {}), ("leaky_relu", {}),
    ("leaky_relu", dict(negative_slope=0.2)), ("elu", {}),
    ("elu", dict(alpha=0.5)), ("selu", {}), ("selu", dict(scale=1.2,
                                                          alpha=1.5)),
    ("celu", {}), ("celu", dict(alpha=2.0)), ("gelu", {}),
    ("gelu", dict(approximate=True)), ("silu", {}), ("swish", {}),
    ("mish", {}), ("sigmoid", {}), ("hardsigmoid", {}),
    # the reference ignores slope and offset
    ("hardsigmoid", dict(slope=0.2, offset=0.4)), ("hardswish", {}),
    ("hardtanh", {}), ("hardtanh", dict(min=-0.5, max=2.0)),
    ("hardshrink", {}), ("hardshrink", dict(threshold=1.0)),
    ("softshrink", {}), ("softshrink", dict(threshold=0.3)),
    ("tanhshrink", {}), ("softplus", {}),
    ("softplus", dict(beta=2.0, threshold=3.0)), ("softsign", {}),
    ("log_sigmoid", {}), ("softmax", {}), ("softmax", dict(axis=1)),
    ("softmax", dict(dtype="float64")), ("log_softmax", {}),
    ("log_softmax", dict(axis=0)), ("thresholded_relu", {}),
    ("thresholded_relu", dict(threshold=0.5, value=-1.0)),
    ("glu", {}), ("glu", dict(axis=1)), ("maxout", dict(groups=2)),
    ("maxout", dict(groups=4, axis=-1)), ("rrelu", {}),
    ("rrelu", dict(lower=0.1, upper=0.2)), ("tanh", {}),
    ("prelu", dict(weight="one")), ("prelu", dict(weight="channels")),
    ("prelu", dict(weight="last", data_format="NLC")),
]


def _case_id(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("case", ACT_CASES, ids=[_case_id(c) for c in
                                                  ACT_CASES])
def test_activation_matches_reference(case):
    name, kw = case
    kw = dict(kw)
    # maxout groups its channel axis (1 by default): 6 channels
    x = _x((3, 6, 8) if name in ("maxout", "glu") else (3, 5, 8))
    extra_j, extra_t = [], []
    if name == "prelu":
        which = kw.pop("weight")
        n = {"one": 1, "channels": x.shape[1], "last": x.shape[-1]}[which]
        w = (0.1 + 0.05 * np.arange(n)).astype(np.float32)
        extra_j, extra_t = [paddle.to_tensor(w)], [torch.from_numpy(w)]
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    jout = getattr(JF, name)(jx, *extra_j, **kw)
    tout = getattr(TF, name)(tx, *extra_t, **kw)
    want = np.asarray(jout.numpy())
    got = tout.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, name
    _close(got, want, TOL, f"{name} output")
    w = _weight_for(want.shape).astype(want.dtype)
    (jout * paddle.to_tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    _close(tx.grad.numpy(), np.asarray(jx.grad.numpy()), TOL,
           f"{name} gradient")


def test_relu_inplace_returns_its_input():
    x = torch.from_numpy(_x())
    out = TF.relu_(x)
    assert out is x and bool((x >= 0).all())


def test_rrelu_training_draws_from_the_generator():
    x = torch.from_numpy(_x((64, 64)))
    lo, hi = 0.1, 0.3

    def draw(seed):
        return TF.rrelu(x, lo, hi, training=True,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    neg = x < 0
    slope = a[neg] / x[neg]
    assert float(slope.min()) >= lo and float(slope.max()) < hi
    assert torch.equal(a[~neg], x[~neg])
    with pytest.raises(ValueError, match="generator"):
        TF.rrelu(x, training=True)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_draws_from_the_generator(hard):
    x = torch.from_numpy(_x((16, 10))).requires_grad_()

    def draw(seed, axis=-1):
        return TF.gumbel_softmax(x, temperature=0.7, hard=hard, axis=axis,
                                 generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(a.sum(-1), torch.ones(16), rtol=0, atol=1e-6)
    if hard:
        assert set(a.detach().unique().tolist()) <= {0.0, 1.0}
    a.sum().backward()                     # straight through: a gradient
    assert x.grad is not None
    assert draw(3, axis=0).sum(0).allclose(torch.ones(10), atol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        TF.gumbel_softmax(x)


@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_reference(bias):
    x, w, b = _x((2, 3, 6)), _x((6, 4), 1), _x((4,), 2)
    jargs = [paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b)]
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, w, b)]
    jout = JF.linear(*jargs[:2], jargs[2] if bias else None)
    tout = TF.linear(*targs[:2], targs[2] if bias else None)
    _close(tout.detach().numpy(), np.asarray(jout.numpy()), TOL, "linear")
    jout.sum().backward()
    tout.sum().backward()
    for j, t, n in zip(jargs, targs, "xwb"):
        if n == "b" and not bias:
            continue
        _close(t.grad.numpy(), np.asarray(j.grad.numpy()), TOL, f"grad {n}")


@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_embedding_matches_reference(padding_idx):
    w = _x((10, 4), 3)
    ids = np.array([[1, 3, 8, 3], [0, 9, 1, 8]], np.int64)
    jw = paddle.to_tensor(w, stop_gradient=False)
    tw = torch.from_numpy(w.copy()).requires_grad_()
    jout = JF.embedding(paddle.to_tensor(ids), jw, padding_idx=padding_idx)
    tout = TF.embedding(torch.from_numpy(ids), tw, padding_idx=padding_idx)
    np.testing.assert_array_equal(tout.detach().numpy(),
                                  np.asarray(jout.numpy()))
    g = _x((2, 4, 4), 4)
    (jout * paddle.to_tensor(g)).sum().backward()
    (tout * torch.from_numpy(g)).sum().backward()
    _close(tw.grad.numpy(), np.asarray(jw.grad.numpy()), TOL, "weight grad")
    if padding_idx is not None:
        pi = padding_idx % 10
        assert not tout[torch.from_numpy(ids) == pi].any()
        assert not tw.grad[pi].any()


def test_embedding_bf16_gradient_sums_in_fp32():
    """Sixteen equal bf16 gradient rows summed into one weight row: in
    bf16 the running sum would round at every step, in fp32 it rounds
    once (the reference's ``_embedding_vjp``)."""
    w = torch.zeros(4, 8, dtype=torch.bfloat16, requires_grad=True)
    ids = torch.full((16,), 2)
    g = torch.full((16, 8), 1.0 + 2 ** -7, dtype=torch.bfloat16)
    TF.embedding(ids, w).backward(g)
    assert w.grad.dtype == torch.bfloat16
    want = torch.tensor(16 * (1.0 + 2 ** -7)).to(torch.bfloat16)
    assert bool((w.grad[2] == want).all()) and not w.grad[[0, 1, 3]].any()


def test_embedding_gradient_is_deterministic_row_sums(monkeypatch):
    """The weight gradient sums each id's rows without atomics (a stable
    sort, fp64 prefix sums along the tokens, one write per id): no
    scatter-add or accumulating index_put_ runs, long runs of one id (two
    ids over 9216 tokens each, as BERT's token types) and scattered ids
    agree with an fp64 sum within one fp32 rounding of it, and the
    ``Embedding`` module gives the same gradient. torch.nn.Embedding's
    CUDA backward gave BERT's token-type rows different bits from run to
    run."""
    g = torch.Generator().manual_seed(3)
    cases = []
    for num, ids in ((2, torch.arange(18432) >= 9216),
                     (300, torch.randint(0, 300, (2, 700), generator=g))):
        ids = ids.long()
        gout = torch.randn(*ids.shape, 16, generator=g)
        want = torch.zeros(num, 16, dtype=torch.float64).index_add_(
            0, ids.reshape(-1), gout.reshape(-1, 16).double())
        cases.append((num, ids, gout, want))

    def refuse(*a, **k):
        raise AssertionError("an atomic scatter-add ran")

    real_put = torch.Tensor.index_put_

    def put(self, idx, vals, accumulate=False):
        if accumulate:
            refuse()
        return real_put(self, idx, vals)

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "scatter_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "index_put_", put)
    for num, ids, gout, want in cases:
        w = torch.randn(num, 16, generator=g, requires_grad=True)
        TF.embedding(ids, w).backward(gout)
        tol = torch.finfo(torch.float32).eps * want.abs().clamp(min=1.0)
        assert bool(((w.grad.double() - want).abs() <= tol).all())
        mod = TF.common.Embedding(num, 16)
        with torch.no_grad():
            mod.weight.copy_(w)
        mod(ids).backward(gout)
        assert torch.equal(mod.weight.grad, w.grad)


def test_embedding_ids_out_of_range_raise_like_the_reference():
    w = _x((5, 3))
    for bad in ([[0, 5]], [[-1, 2]]):
        ids = np.array(bad, np.int64)
        with pytest.raises(ValueError, match="expected >= 0 and < 5") as j:
            JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w))
        with pytest.raises(ValueError, match="expected >= 0 and < 5") as t:
            TF.embedding(torch.from_numpy(ids), torch.from_numpy(w))
        assert str(t.value) == str(j.value)


LN_CASES = [("float32", True, [8]), ("float32", False, [8]),
            ("float32", True, [5, 8]), ("bfloat16", True, [8]),
            ("bfloat16", True, [5, 8])]


@pytest.mark.parametrize("dtype,affine,shape", LN_CASES,
                         ids=[f"{d}-{'affine' if a else 'plain'}-{len(s)}d"
                              for d, a, s in LN_CASES])
def test_layer_norm_matches_reference(dtype, affine, shape):
    """fp32 within 1e-5; bf16 forward and gradients within one bf16 ulp
    of the reference (both compute in fp32 and round once; fp32 sums in
    another order can move a value across a rounding edge)."""
    x = _x((3, 5, 8), 5) + 3.0
    w, b = _x(tuple(shape), 6) + 1.0, _x(tuple(shape), 7)
    g = _x((3, 5, 8), 8)
    j_in = [paddle.to_tensor(a, dtype=dtype, stop_gradient=False)
            for a in (x, w, b)]
    t_in = [torch.from_numpy(a.copy()).to(getattr(torch, dtype))
            .requires_grad_() for a in (x, w, b)]
    jargs = j_in[1:] if affine else [None, None]
    targs = t_in[1:] if affine else [None, None]
    jout = JF.layer_norm(j_in[0], shape, *jargs, epsilon=1e-5)
    tout = TF.layer_norm(t_in[0], shape, *targs, epsilon=1e-5)
    assert tout.dtype == getattr(torch, dtype)
    (jout * paddle.to_tensor(g).astype(dtype)).sum().backward()
    (tout * torch.from_numpy(g).to(tout.dtype)).sum().backward()
    pairs = [("out", tout, jout)] + [
        (f"grad {n}", t.grad, j.grad)
        for n, t, j in zip("xwb", t_in, j_in) if n == "x" or affine]
    for what, t, j in pairs:
        want = np.asarray(j.astype("float32").numpy())
        got = t.detach().float().numpy()
        if dtype == "float32":
            _close(got, want, 1e-5, what)
        else:
            ulp = np.abs(want) * 2.0 ** -7 + 1e-30
            assert (np.abs(got - want) <= ulp).all(), (
                what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("mode,training,p", [
    ("upscale_in_train", False, 0.3), ("downscale_in_infer", False, 0.3),
    ("upscale_in_train", True, 0.0), ("downscale_in_infer", True, 0.0),
    ("upscale_in_train", True, 1.0), ("downscale_in_infer", True, 1.0),
    ("downscale_in_infer", False, 1.0)])
def test_dropout_deterministic_cases_match_reference(mode, training, p):
    x = _x()
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    jout = JF.dropout(jx, p, training=training, mode=mode)
    tout = TF.dropout(tx, p, training=training, mode=mode)
    np.testing.assert_array_equal(tout.detach().numpy(),
                                  np.asarray(jout.numpy()))
    jout.sum().backward()
    tout.sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jx.grad.numpy()))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_dropout_masks_within_the_port(mode, p):
    x = torch.from_numpy(_x((64, 128)))
    out = TF.dropout(x, p, mode=mode,
                     generator=torch.Generator().manual_seed(4))
    again = TF.dropout(x, p, mode=mode,
                       generator=torch.Generator().manual_seed(4))
    other = TF.dropout(x, p, mode=mode,
                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(out, again) and not torch.equal(out, other)
    kept = out != 0
    n = x.numel()
    rate = float(kept.float().mean())
    assert abs(rate - (1 - p)) <= 4 * (p * (1 - p) / n) ** 0.5, rate
    want = x / (1 - p) if mode == "upscale_in_train" else x
    assert torch.equal(out[kept], want[kept])


@pytest.mark.parametrize("axis", [0, 1, [0, 2], (1, 2)])
def test_dropout_axis_shares_one_mask_per_slice(axis):
    """With ``axis`` the mask has the input's size on those axes and is
    broadcast along the others, as the reference's ``dropout_axis_p``."""
    x = torch.from_numpy(_x((6, 7, 9))).abs() + 0.1
    out = TF.dropout(x, 0.5, axis=axis,
                     generator=torch.Generator().manual_seed(1))
    axes = {axis} if isinstance(axis, int) else set(axis)
    kept = out != 0
    for other in set(range(3)) - axes:
        ref = kept.narrow(other, 0, 1)
        assert torch.equal(kept, ref.expand_as(kept)), other
    assert kept.any() and not kept.all()


def test_dropout_needs_a_generator_and_replays_under_a_tape():
    x = torch.from_numpy(_x())
    with pytest.raises(ValueError, match="generator"):
        TF.dropout(x, 0.5)
    gen = torch.Generator().manual_seed(9)
    tape = GeneratorTape()
    with tape.run():
        first = TF.dropout(x, 0.5, generator=gen)
    with tape.run():
        replay = TF.dropout(x, 0.5, generator=gen)
    after = TF.dropout(x, 0.5, generator=gen)
    assert torch.equal(first, replay) and not torch.equal(first, after)
