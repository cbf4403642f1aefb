"""The rest of ``nn.functional`` in the port
(paddle_tpu_torch/nn/functional/common.py's ``pad``, ``cosine_similarity``,
``bilinear``, ``label_smooth`` and the dropouts; __init__.py's in-place
activations, ``feature_alpha_dropout``, ``sparse_attention`` and
``flash_attention_with_sparse_mask``) against the reference's on the CPU,
from the same numpy inputs, fp32.

``CASES`` holds one case per function and option: the output within
1e-5 of its own max |value| (absolute below 1), and the gradient of
``sum(out * w)`` (``w`` fixed random weights) for every float input the
case lists, within 1e-4 of that gradient's max |g| (absolute below 1).
``pad`` runs every mode in both forms, NCHW and NHWC, on a non-spatial
dim and with widths past the dim's size. The dropouts draw from the
port's own generator, so they are held within the port: seed for seed,
``p = 0`` and eval the identity, the kept share, and alpha dropout's
mean and variance on standard-normal input.
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


def _f(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


def run_case(fn, inputs, kw, grads=(0,), seed=0, ref_fn=None):
    """``fn`` of both packages on ``inputs`` (numpy) and ``kw``; outputs
    and the gradients of the inputs at ``grads`` compared."""
    j_in = [paddle.to_tensor(a, stop_gradient=i not in grads)
            for i, a in enumerate(inputs)]
    t_in = [torch.tensor(np.asarray(a)).requires_grad_(i in grads)
            for i, a in enumerate(inputs)]
    j_out = (ref_fn or getattr(JF, fn))(*j_in, **kw)
    t_out = getattr(TF, fn)(*t_in, **kw)
    want = np.asarray(j_out._value)
    _close(t_out.detach().numpy(), want, OUT_TOL, f"{fn} output")
    if not grads:
        return t_out
    w = np.random.default_rng(seed).normal(size=want.shape).astype(
        np.float32)
    (j_out * paddle.to_tensor(w)).sum().backward()
    (t_out * torch.from_numpy(w)).sum().backward()
    for i in grads:
        _close(t_in[i].grad.numpy(), np.asarray(j_in[i].grad._value),
               GRAD_TOL, f"{fn} gradient {i}")
    return t_out


def _csr(rng, b, h, s, density=0.4):
    """A CSR pattern with at least the diagonal in every row."""
    offs = np.zeros((b, h, s + 1), np.int32)
    cols_all = []
    for i in range(b):
        for j in range(h):
            row_cols = []
            for r in range(s):
                c = sorted(set(np.flatnonzero(rng.random(s) < density)) | {r})
                row_cols.append(c)
                offs[i, j, r + 1] = offs[i, j, r] + len(c)
            cols_all.append([c for rc in row_cols for c in rc])
    nnz = max(len(c) for c in cols_all)
    cols = np.zeros((b, h, nnz), np.int32)
    for k, c in enumerate(cols_all):
        cols[k // h, k % h, :len(c)] = c
    return offs, cols


PAD_CASES = [
    # (id, shape, pad, mode, data_format)
    ("const_partial_nchw", (2, 3, 4, 5), [1, 2, 0, 3], "constant", "NCHW"),
    ("const_value_full", (2, 3, 4), [1, 0, 0, 2, 3, 1], "constant", "NCL"),
    ("reflect_partial_nchw", (2, 3, 5, 6), [2, 1, 3, 2], "reflect", "NCHW"),
    ("reflect_partial_nhwc", (2, 5, 6, 3), [2, 1, 3, 2], "reflect", "NHWC"),
    ("reflect_wide", (1, 2, 4), [9, 7], "reflect", "NCL"),
    ("reflect_full_batch_dim", (4, 3, 5), [2, 1, 0, 0, 0, 0], "reflect",
     "NCL"),
    ("replicate_partial_ncdhw", (1, 2, 3, 4, 5), [1, 2, 2, 1, 1, 1],
     "replicate", "NCDHW"),
    ("replicate_partial_nlc", (2, 5, 3), [3, 4], "replicate", "NLC"),
    ("replicate_full_channel", (2, 3, 4, 4), [0, 0, 2, 3, 0, 0, 1, 0],
     "replicate", "NCHW"),
    ("circular_partial_nchw", (2, 3, 4, 5), [1, 2, 2, 1], "circular",
     "NCHW"),
    ("circular_wide_nhwc", (1, 3, 2, 2), [5, 4, 1, 7], "circular", "NHWC"),
    ("circular_full_all_dims", (3, 2, 4), [1, 1, 2, 0, 0, 3], "circular",
     "NCL"),
]


@pytest.mark.parametrize("case", PAD_CASES, ids=[c[0] for c in PAD_CASES])
def test_pad_matches_reference(case):
    _, shape, pad, mode, fmt = case
    x = _f(np.random.default_rng(len(case[0])), *shape)
    kw = dict(pad=pad, mode=mode, data_format=fmt)
    if mode == "constant":
        kw["value"] = 0.5
    run_case("pad", [x], kw)


def test_pad_takes_a_tensor_and_rejects_unknown_modes():
    x = torch.arange(6.0).reshape(1, 1, 6)
    assert torch.equal(TF.pad(x, torch.tensor([1, 1]), mode="replicate"),
                       TF.pad(x, [1, 1], mode="replicate"))
    with pytest.raises(ValueError, match="mode"):
        TF.pad(x, [1, 1], mode="symmetric")


def _near_zero(rng):
    x1 = _f(rng, 6, 8)
    x1[2] *= 1e-6                     # a near-zero row
    return [x1, _f(rng, 6, 8)]


CASES = [
    ("cosine_axis1", "cosine_similarity",
     lambda r: ([_f(r, 5, 7), _f(r, 5, 7)], {}), (0, 1)),
    ("cosine_axis0_eps", "cosine_similarity",
     lambda r: ([_f(r, 7, 5), _f(r, 7, 5)], dict(axis=0, eps=1e-3)), (0, 1)),
    ("cosine_near_zero_row", "cosine_similarity",
     lambda r: (_near_zero(r), {}), (0, 1)),
    ("cosine_broadcast", "cosine_similarity",
     lambda r: ([_f(r, 4, 6, 3), _f(r, 1, 6, 3)], {}), (0, 1)),
    ("bilinear_bias", "bilinear",
     lambda r: ([_f(r, 5, 3), _f(r, 5, 4), _f(r, 6, 3, 4), _f(r, 1, 6)],
                {}), (0, 1, 2, 3)),
    ("bilinear_no_bias", "bilinear",
     lambda r: ([_f(r, 5, 3), _f(r, 5, 4), _f(r, 2, 3, 4)], {}), (0, 1, 2)),
    ("label_smooth", "label_smooth",
     lambda r: ([np.eye(6, dtype=np.float32)[r.integers(0, 6, 8)]],
                dict(epsilon=0.2)), (0,)),
    ("label_smooth_prior", "label_smooth",
     lambda r: ([np.eye(6, dtype=np.float32)[r.integers(0, 6, 8)],
                 np.full((1, 6), 1 / 6, np.float32)], {}), (0, 1)),
    ("dropout2d_eval", "dropout2d",
     lambda r: ([_f(r, 2, 3, 4, 4)], dict(p=0.5, training=False)), (0,)),
    ("dropout3d_p0", "dropout3d",
     lambda r: ([_f(r, 2, 3, 2, 4, 4)], dict(p=0.0)), (0,)),
    ("alpha_dropout_eval", "alpha_dropout",
     lambda r: ([_f(r, 4, 5)], dict(p=0.3, training=False)), (0,)),
    ("feature_alpha_dropout_p0", "feature_alpha_dropout",
     lambda r: ([_f(r, 2, 3, 4)], dict(p=0.0)), ()),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_function_matches_reference(case):
    _, fn, make, grads = case
    inputs, kw = make(np.random.default_rng(len(case[0])))
    run_case(fn, inputs, kw, grads)


INPLACE = [("elu_", "elu", dict(alpha=0.7)),
           ("hardtanh_", "hardtanh", dict(min=-0.5, max=0.8)),
           ("leaky_relu_", "leaky_relu", dict(negative_slope=0.2)),
           ("softmax_", "softmax", dict(axis=0)),
           ("tanh_", "tanh", {}),
           ("thresholded_relu_", "thresholded_relu", dict(threshold=0.3))]


@pytest.mark.parametrize("name, base, kw", INPLACE,
                         ids=[c[0] for c in INPLACE])
def test_inplace_activation_values_and_gradients(name, base, kw):
    """On a non-leaf: the result is written into ``x`` and returned, equal
    to the reference's in-place op, and the gradient flows through it as
    through the reference's."""
    rng = np.random.default_rng(len(name))
    x = _f(rng, 5, 6)
    w = _f(rng, 5, 6)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jx * 1.0
    jr = getattr(JF, name)(jy, **kw)
    (jr * paddle.to_tensor(w)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = tx * 1.0
    tr = getattr(TF, name)(ty, **kw)
    assert tr is ty
    _close(tr.detach().numpy(), np.asarray(jr._value), OUT_TOL, name)
    (tr * torch.from_numpy(w)).sum().backward()
    _close(tx.grad.numpy(), np.asarray(jx.grad._value), GRAD_TOL, name)
    # without autograd the op writes in place too
    plain = torch.from_numpy(x.copy())
    assert getattr(TF, name)(plain, **kw) is plain
    _close(plain.numpy(), getattr(TF, base)(torch.from_numpy(x), **kw),
           0.0, name)
    # a leaf that requires grad: torch refuses (the reference rebinds)
    with pytest.raises(RuntimeError, match="leaf"):
        getattr(TF, name)(torch.from_numpy(x).requires_grad_(), **kw)


def _dense_mask(offs, cols, s):
    """The CSR pattern as a dense additive mask, row by row in numpy."""
    b, h = offs.shape[:2]
    mask = np.full((b, h, s, s), -1e9, np.float32)
    for i in range(b):
        for j in range(h):
            for r in range(s):
                mask[i, j, r, cols[i, j, offs[i, j, r]:offs[i, j, r + 1]]] = 0
    return mask


@pytest.mark.parametrize("masks", ["none", "key_padding", "both"])
def test_sparse_attention_matches_reference(masks):
    """Values against the reference's. The reference reads its inputs'
    values (no gradient), so the gradients are held against ``jax.vjp``
    of the same masked attention over the pattern made dense in numpy."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    b, h, s, d = 2, 2, 12, 8
    q, k, v = (_f(rng, b, h, s, d) for _ in range(3))
    offs, cols = _csr(rng, b, h, s)
    extra = {}
    add = _dense_mask(offs, cols, s)
    if masks in ("key_padding", "both"):
        kpm = np.zeros((b, s), np.float32)
        kpm[0, -3:] = -1e9
        extra["key_padding_mask"] = kpm
        add = add + kpm[:, None, None, :]
    if masks == "both":
        am = np.triu(np.full((s, s), -1e9, np.float32), 1)
        extra["attn_mask"] = am
        add = add + am[None, None]
    jo = JF.sparse_attention(*(paddle.to_tensor(a) for a in
                               (q, k, v, offs, cols)),
                             **{n: paddle.to_tensor(a)
                                for n, a in extra.items()})
    t_in = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    to = TF.sparse_attention(*t_in, torch.from_numpy(offs),
                             torch.from_numpy(cols),
                             **{n: torch.from_numpy(a)
                                for n, a in extra.items()})
    _close(to.detach().numpy(), np.asarray(jo._value), OUT_TOL, "out")

    def attend(q, k, v):
        sc = jnp.einsum("bhqd,bhkd->bhqk", q, k) / float(np.sqrt(d)) + add
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(sc, -1), v)

    want, vjp = jax.vjp(attend, q, k, v)
    _close(to.detach().numpy(), np.asarray(want), OUT_TOL, "out vs dense")
    w = _f(rng, b, h, s, d)
    (to * torch.from_numpy(w)).sum().backward()
    for t, g in zip(t_in, vjp(jnp.asarray(w))):
        _close(t.grad.numpy(), np.asarray(g), GRAD_TOL, "grad")


def test_sparse_attention_keeps_the_query_dtype():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(_f(rng, 1, 1, 4, 8)).to(torch.bfloat16)
    offs, cols = _csr(rng, 1, 1, 4)
    out = TF.sparse_attention(q, q, q, torch.from_numpy(offs),
                              torch.from_numpy(cols))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("start_rows, causal", [
    (False, True), (False, False), (True, True)])
def test_flash_attention_with_sparse_mask_matches_reference(start_rows,
                                                            causal):
    """No start rows: causal (or not) SDPA, at head dim 64 through the
    flash gate (the kernels' plain versions on the CPU). Start rows: the
    reference's [B, H, S, S] mask through the plain masked path."""
    rng = np.random.default_rng(7)
    b, s, h, d = 2, 16, 2, 64
    inputs = [_f(rng, b, s, h, d, scale=0.5) for _ in range(3)]
    kw = dict(is_causal=causal)
    if start_rows:
        sr = rng.integers(0, s + 1, (b, h, s)).astype(np.int32)
        sr = np.maximum(sr, np.arange(s)[None, None, :] + 1)   # keep diag
        inputs.append(sr)
    run_case("flash_attention_with_sparse_mask", inputs, kw, (0, 1, 2))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("fn, shape, axes", [
    ("dropout2d", (8, 16, 5, 5), (0, 1)),
    ("dropout3d", (8, 16, 2, 3, 3), (0, 1)),
    ("feature_alpha_dropout", (8, 16, 5, 5), (0, 1)),
    ("alpha_dropout", (64, 64), (0, 1))])
def test_dropouts_within_the_port(fn, shape, axes):
    x = torch.randn(*shape, generator=_gen(1))
    f = getattr(TF, fn)
    a = f(x, p=0.3, generator=_gen(4))
    assert torch.equal(a, f(x, p=0.3, generator=_gen(4)))
    assert not torch.equal(a, f(x, p=0.3, generator=_gen(5)))
    assert torch.equal(f(x, p=0.0), x) and torch.equal(
        f(x, p=0.3, training=False), x)
    with pytest.raises(ValueError, match="generator"):
        f(x, p=0.3)
    rest = tuple(i for i in range(x.ndim) if i not in axes)
    if fn.startswith("dropout"):
        kept = (a != 0)
        # whole maps are kept (scaled by 1 / 0.7) or zeroed
        assert torch.equal(kept.all(dim=rest), kept.any(dim=rest))
        torch.testing.assert_close(a[kept], x[kept] / 0.7)
        share = float(kept.all(dim=rest).float().mean())
        assert abs(share - 0.7) < 0.15
    else:
        alpha_p = -1.0507009873554805 * 1.6732632423543772
        scale = ((1 - 0.3) * (1 + 0.3 * alpha_p ** 2)) ** -0.5
        dropped = torch.isclose(a, torch.tensor(scale * alpha_p * 0.7))
        if fn == "feature_alpha_dropout":
            assert torch.equal(dropped.all(dim=rest), dropped.any(dim=rest))
        assert abs(float(dropped.float().mean()) - 0.3) < 0.15


def test_alpha_dropout_keeps_mean_and_variance():
    x = torch.randn(400, 500, generator=_gen(2))
    for p in (0.1, 0.5):
        y = TF.alpha_dropout(x, p=p, generator=_gen(3))
        assert abs(float(y.mean())) < 0.02
        assert abs(float(y.var()) - 1.0) < 0.03
