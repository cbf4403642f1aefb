"""The port's gradient clipping (paddle_tpu_torch/nn/clip.py and
paddle_tpu_torch/nn/utils) against the reference package's
(paddle_tpu/nn/clip.py, paddle_tpu/nn/utils/__init__.py), on the CPU:
the same gradients through the three clip classes and both pairs of
functions, with clip limits above and below the gradients' norms, a
parameter without a gradient and one marked ``need_clip = False``.

Tolerances: fp32 gradients within 1e-6 of each gradient's own max |g|
(norms summed in another order); bf16 gradients within one bf16 ulp
(2 ** -7 relative: both scale in fp32 and round once, so an fp32 scale
a few ulps apart can round to the neighbouring bf16 value). Returned
total norms: 1e-6 relative in fp32, one ulp in bf16 (the inf-norm is
taken in the gradients' dtype in both packages).
"""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn import utils as jutils

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import utils as tutils

SHAPES = [(7, 5), (5,), (3, 4, 2), (6,)]
NO_GRAD = 3                 # SHAPES[3] has no gradient
NO_CLIP = 1                 # SHAPES[1] is marked need_clip = False
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _check(got, want, dtype):
    """Port gradient vs reference gradient (numpy, float32)."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-30))
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)


def _pairs(grads, dtype):
    """(port pairs, reference pairs) over the same gradients in ``dtype``;
    the reference's parameter for ``NO_CLIP`` is a stand-in carrying
    ``need_clip = False`` (its ``Parameter`` has no such slot)."""
    tdt, jdt = DTYPES[dtype]
    tps = [torch.nn.Parameter(torch.zeros(s, dtype=tdt)) for s in SHAPES]
    tps[NO_CLIP].need_clip = False
    jps = [Parameter(jnp.zeros(s, jdt)) for s in SHAPES]
    jps[NO_CLIP] = types.SimpleNamespace(need_clip=False)
    tpg = [(p, None if i == NO_GRAD else torch.tensor(g).to(tdt))
           for i, (p, g) in enumerate(zip(tps, grads))]
    jpg = [(p, None if i == NO_GRAD else paddle.to_tensor(
        np.asarray(jnp.asarray(g, jdt)))) for i, (p, g) in
        enumerate(zip(jps, grads))]
    return tpg, jpg


CLASSES = [
    ("value", lambda m: m.ClipGradByValue(0.5)),
    ("value_min", lambda m: m.ClipGradByValue(0.8, min=-0.3)),
    ("norm_binds", lambda m: m.ClipGradByNorm(1.0)),
    ("norm_loose", lambda m: m.ClipGradByNorm(100.0)),
    ("global_binds", lambda m: m.ClipGradByGlobalNorm(1.0)),
    ("global_loose", lambda m: m.ClipGradByGlobalNorm(100.0)),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CLASSES, ids=[c[0] for c in CLASSES])
def test_clip_class_matches_reference(case, dtype):
    _, make = case
    tpg, jpg = _pairs(_grads(0), dtype)
    before = [None if g is None else g.clone() for _, g in tpg]
    t_out = make(tnn)(tpg)
    j_out = make(jclip)(jpg)
    # the classes return clipped copies and leave the gradients alone
    for (_, g), b in zip(tpg, before):
        assert (g is None and b is None) or torch.equal(g, b)
    assert len(t_out) == len(j_out) == len(SHAPES)
    for i, ((_, tg), (_, jg)) in enumerate(zip(t_out, j_out)):
        if i == NO_GRAD:
            assert tg is None and jg is None
            continue
        assert tg.dtype == DTYPES[dtype][0]
        _check(tg.float().numpy(), np.asarray(jg._value).astype(np.float32),
               dtype)
    if case[0] == "value":
        # need_clip = False: only ClipGradByValue honours it
        assert float(t_out[NO_CLIP][1].abs().max()) > 0.5


def _params(grads, dtype, pkg):
    tdt, jdt = DTYPES[dtype]
    if pkg == "torch":
        ps = [torch.nn.Parameter(torch.zeros(s, dtype=tdt)) for s in SHAPES]
        for i, (p, g) in enumerate(zip(ps, grads)):
            if i != NO_GRAD:
                p.grad = torch.tensor(g).to(tdt)
        return ps
    ps = [Parameter(jnp.zeros(s, jdt)) for s in SHAPES]
    for i, (p, g) in enumerate(zip(ps, grads)):
        if i != NO_GRAD:
            p._grad_value = jnp.asarray(g, jdt)
    return ps


def _grads_np(ps, pkg):
    if pkg == "torch":
        return [None if p.grad is None else p.grad.float().numpy()
                for p in ps]
    return [None if p._grad_value is None
            else np.asarray(p._grad_value).astype(np.float32) for p in ps]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("norm_type", [2.0, 1.5, math.inf])
@pytest.mark.parametrize("max_norm", [1.0, 1e3], ids=["binds", "loose"])
@pytest.mark.parametrize("where", ["clip", "utils"])
def test_clip_grad_norm_matches_reference(where, max_norm, norm_type, dtype):
    tmod, jmod = (tclip, jclip) if where == "clip" else (tutils, jutils)
    grads = _grads(1)
    tps, jps = _params(grads, dtype, "torch"), _params(grads, dtype, "jax")
    t_total = tmod.clip_grad_norm_(tps, max_norm, norm_type=norm_type)
    j_total = jmod.clip_grad_norm_(jps, max_norm, norm_type=norm_type)
    want = float(np.asarray(j_total._value).astype(np.float32))
    rtol = 1e-6 if dtype == "float32" or norm_type != math.inf else BF16_ULP
    np.testing.assert_allclose(float(t_total), want, rtol=rtol, atol=0)
    for i, (tg, jg) in enumerate(zip(_grads_np(tps, "torch"),
                                     _grads_np(jps, "jax"))):
        if i == NO_GRAD:
            assert tg is None and jg is None
        else:
            _check(tg, jg, dtype)


@pytest.mark.parametrize("clip_value", [0.4, -0.4])
@pytest.mark.parametrize("where", ["clip", "utils"])
def test_clip_grad_value_matches_reference(where, clip_value):
    # nn.utils clamps into [-|v|, |v|]; nn.clip takes v as given, so a
    # negative v there clamps every entry to v
    tmod, jmod = (tclip, jclip) if where == "clip" else (tutils, jutils)
    grads = _grads(2)
    tps, jps = _params(grads, "float32", "torch"), _params(grads, "float32",
                                                          "jax")
    tmod.clip_grad_value_(tps, clip_value)
    jmod.clip_grad_value_(jps, clip_value)
    for tg, jg in zip(_grads_np(tps, "torch"), _grads_np(jps, "jax")):
        if jg is None:
            assert tg is None
        else:
            np.testing.assert_array_equal(tg, jg)


def test_error_if_nonfinite_only_in_nn_utils():
    grads = _grads(3)
    grads[0][1, 2] = np.inf
    for tmod, jmod in ((tutils, jutils), (tclip, jclip)):
        tps = _params(grads, "float32", "torch")
        jps = _params(grads, "float32", "jax")
        if tmod is tutils:
            with pytest.raises(RuntimeError, match="non-finite"):
                tmod.clip_grad_norm_(tps, 1.0, error_if_nonfinite=True)
            with pytest.raises(RuntimeError, match="non-finite"):
                jmod.clip_grad_norm_(jps, 1.0, error_if_nonfinite=True)
        else:
            t_total = tmod.clip_grad_norm_(tps, 1.0, error_if_nonfinite=True)
            j_total = jmod.clip_grad_norm_(jps, 1.0, error_if_nonfinite=True)
            assert math.isinf(float(t_total)) and math.isinf(float(j_total))


def test_no_gradients():
    ps = [torch.nn.Parameter(torch.zeros(3))]
    for fn in (tclip.clip_grad_norm_, tutils.clip_grad_norm_):
        total = fn(ps, 1.0)
        assert total.dtype == torch.float32 and float(total) == 0.0
    assert tnn.ClipGradByGlobalNorm(1.0)([(ps[0], None)]) == [(ps[0], None)]


def test_global_norm_clip_returns_copies():
    # as the reference: new clipped gradients, the given ones untouched
    tpg, _ = _pairs(_grads(4), "bfloat16")
    before = [None if g is None else g.clone() for _, g in tpg]
    out = tnn.ClipGradByGlobalNorm(1.0)(tpg)
    for (_, g), (_, o), b in zip(tpg, out, before):
        if b is None:
            assert g is None and o is None
            continue
        assert o is not g and torch.equal(g, b)
    total = torch.linalg.vector_norm(torch.stack(
        [g.float().norm() for _, g in out if g is not None]))
    assert abs(float(total) - 1.0) < 1e-2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_global_norm_clip_matches_reference_at_2_24_elements(dtype):
    # torch's CPU fp32 norm adds in order and misses by 7e-4 here; the
    # port accumulates the CPU's norms in fp64, the reference is a tree
    tdt, jdt = DTYPES[dtype]
    g = (np.random.default_rng(5).normal(size=1 << 24) * 1e-3).astype(
        np.float32)
    t_out = tnn.ClipGradByGlobalNorm(1.0)(
        [(torch.nn.Parameter(torch.zeros(1)), torch.from_numpy(g).to(tdt))])
    j_out = jclip.ClipGradByGlobalNorm(1.0)(
        [(Parameter(jnp.zeros(1)), paddle.to_tensor(
            np.asarray(jnp.asarray(g, jdt))))])
    _check(t_out[0][1].float().numpy(),
           np.asarray(j_out[0][1]._value).astype(np.float32), dtype)
