"""The port's unpooling, power-average and fractional max pools
(paddle_tpu_torch/nn/functional/extra_pooling.py) and its vision
geometry ops (vision.py) against the reference's on the CPU, from the
same numpy inputs, fp32.

Outputs within 1e-5 of their own max |value| (absolute below 1);
gradients of ``sum(out * w)`` (``w`` fixed random weights) within 1e-4
of their own max |g| (absolute below 1). ``max_unpool*`` takes each
package's own ``max_pool*d(return_mask=True)`` indices (equal here).
The reference's fractional max pools read their input's values (no
gradient there), so the port's gradient is held against the reference's
mask: ``w`` summed into the input at each window's maximum. ``grid_sample``
runs every mode x padding mode x ``align_corners``, on grids that reach
past the input.
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


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


def run_case(fn, inputs, kw, grads=(0,), seed=0):
    j_in = [paddle.to_tensor(a, stop_gradient=i not in grads)
            for i, a in enumerate(inputs)]
    t_in = [torch.from_numpy(a).requires_grad_(i in grads)
            for i, a in enumerate(inputs)]
    j_out = getattr(JF, fn)(*j_in, **kw)
    t_out = getattr(TF, fn)(*t_in, **kw)
    want = np.asarray(j_out._value)
    _close(t_out.detach().numpy(), want, OUT_TOL, f"{fn} output")
    if grads:
        w = np.random.default_rng(seed).normal(size=want.shape).astype(
            np.float32)
        (j_out * paddle.to_tensor(w)).sum().backward()
        (t_out * torch.from_numpy(w)).sum().backward()
        for i in grads:
            _close(t_in[i].grad.numpy(), np.asarray(j_in[i].grad._value),
                   GRAD_TOL, f"{fn} gradient {i}")


UNPOOL_CASES = [
    ("1d", (2, 3, 12), dict(kernel_size=2), {}),
    ("1d_overlap", (2, 3, 11), dict(kernel_size=3, stride=2), {}),
    ("2d", (2, 3, 8, 6), dict(kernel_size=2), {}),
    ("2d_stride_pad", (2, 2, 9, 7), dict(kernel_size=3, stride=2, padding=1),
     {}),
    ("2d_output_size", (1, 2, 7, 7), dict(kernel_size=2),
     dict(output_size=[1, 2, 7, 7])),
    ("3d", (1, 2, 4, 6, 4), dict(kernel_size=2), {}),
]


@pytest.mark.parametrize("case", UNPOOL_CASES,
                         ids=[c[0] for c in UNPOOL_CASES])
def test_max_unpool_matches_reference(case):
    name, shape, pool, extra = case
    nd = len(shape) - 2
    x = _f(np.random.default_rng(len(name)), *shape)
    jo, jm = getattr(JF, f"max_pool{nd}d")(paddle.to_tensor(x),
                                           return_mask=True, **pool)
    to, tm = getattr(TF, f"max_pool{nd}d")(torch.from_numpy(x),
                                           return_mask=True, **pool)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm._value))
    assert tm.dtype == torch.int32
    run_case(f"max_unpool{nd}d", [to.detach().numpy(), tm.numpy()],
             dict(pool, **extra))


LP_CASES = [
    ("1d_p2", "lp_pool1d", (2, 3, 11), dict(norm_type=2, kernel_size=3)),
    ("1d_p3_stride_pad_ceil", "lp_pool1d", (2, 3, 10),
     dict(norm_type=3, kernel_size=3, stride=2, padding=1, ceil_mode=True)),
    ("1d_nlc", "lp_pool1d", (2, 9, 3),
     dict(norm_type=2, kernel_size=2, data_format="NLC")),
    ("2d_p2", "lp_pool2d", (2, 3, 8, 7), dict(norm_type=2, kernel_size=2)),
    ("2d_p1_5_ceil", "lp_pool2d", (2, 2, 7, 9),
     dict(norm_type=1.5, kernel_size=(3, 2), stride=2, ceil_mode=True)),
    ("2d_inf_pad", "lp_pool2d", (2, 2, 7, 7),
     dict(norm_type=float("inf"), kernel_size=3, stride=2, padding=1)),
    ("2d_nhwc", "lp_pool2d", (2, 6, 6, 3),
     dict(norm_type=2, kernel_size=2, data_format="NHWC")),
]


@pytest.mark.parametrize("case", LP_CASES, ids=[c[0] for c in LP_CASES])
def test_lp_pool_matches_reference(case):
    name, fn, shape, kw = case
    x = _f(np.random.default_rng(len(name)), *shape, lo=0.1, hi=2.0)
    x *= np.where(np.random.default_rng(1).random(shape) < 0.5, -1, 1
                  ).astype(np.float32)
    run_case(fn, [x], kw)


FRAC_CASES = [
    ("2d", 2, (2, 3, 11, 9), dict(output_size=(4, 3), random_u=0.3)),
    ("2d_square", 2, (1, 2, 10, 10), dict(output_size=5, random_u=0.71)),
    ("2d_kernel", 2, (2, 2, 12, 12), dict(output_size=5, kernel_size=3,
                                          random_u=0.5)),
    ("3d", 3, (1, 2, 7, 8, 9), dict(output_size=(3, 4, 4), random_u=0.2)),
    ("3d_kernel", 3, (1, 2, 8, 8, 8), dict(output_size=3, kernel_size=2,
                                           random_u=0.9)),
]


@pytest.mark.parametrize("case", FRAC_CASES, ids=[c[0] for c in FRAC_CASES])
def test_fractional_max_pool_matches_reference(case):
    name, nd, shape, kw = case
    rng = np.random.default_rng(len(name))
    x = _f(rng, *shape)
    fn = f"fractional_max_pool{nd}d"
    j_out = getattr(JF, fn)(paddle.to_tensor(x), **kw)
    tx = torch.from_numpy(x).requires_grad_()
    t_out = getattr(TF, fn)(tx, **kw)
    _close(t_out.detach().numpy(), np.asarray(j_out._value), OUT_TOL, "out")
    jo, jm = getattr(JF, fn)(paddle.to_tensor(x), return_mask=True, **kw)
    to, tm = getattr(TF, fn)(torch.from_numpy(x), return_mask=True, **kw)
    _close(to.numpy(), np.asarray(jo._value), OUT_TOL, "out with mask")
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm._value))
    assert tm.dtype == torch.int32
    # the gradient: w summed into the input at each window's maximum
    w = rng.normal(size=t_out.shape).astype(np.float32)
    (t_out * torch.from_numpy(w)).sum().backward()
    want = np.zeros((shape[0], shape[1], int(np.prod(shape[2:]))),
                    np.float32)
    mask = np.asarray(jm._value).reshape(shape[0], shape[1], -1)
    for n in range(shape[0]):
        for c in range(shape[1]):
            np.add.at(want[n, c], mask[n, c], w[n, c].reshape(-1))
    _close(tx.grad.numpy(), want.reshape(shape), GRAD_TOL, "grad")


def test_fractional_max_pool_draws_u_from_a_generator():
    x = torch.randn(1, 2, 13, 13, generator=torch.Generator().manual_seed(0))
    outs = [TF.fractional_max_pool2d(
        x, 5, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == (1, 2, 5, 5)
    with pytest.raises(ValueError, match="generator"):
        TF.fractional_max_pool2d(x, 5)


GRID_CASES = [(mode, pad, ac) for mode in ("bilinear", "nearest")
              for pad in ("zeros", "border", "reflection")
              for ac in (True, False)]


@pytest.mark.parametrize("mode, padding_mode, align_corners", GRID_CASES)
def test_grid_sample_matches_reference(mode, padding_mode, align_corners):
    rng = np.random.default_rng(len(mode) + len(padding_mode))
    x = _f(rng, 2, 3, 5, 7)
    grid = _f(rng, 2, 4, 6, 2, lo=-1.4, hi=1.4)
    grads = (0, 1) if mode == "bilinear" else (0,)
    run_case("grid_sample", [x, grid], dict(
        mode=mode, padding_mode=padding_mode, align_corners=align_corners),
        grads)


def test_grid_sample_rejects_unknown_modes():
    x, g = torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 1, 2)
    with pytest.raises(ValueError, match="mode"):
        TF.grid_sample(x, g, mode="bicubic")
    with pytest.raises(ValueError, match="padding_mode"):
        TF.grid_sample(x, g, padding_mode="mirror")


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid_matches_reference(align_corners):
    rng = np.random.default_rng(3)
    theta = _f(rng, 2, 2, 3)
    run_case("affine_grid", [theta], dict(out_shape=[2, 3, 5, 4],
                                          align_corners=align_corners))
    grid = TF.affine_grid(torch.from_numpy(theta), torch.tensor([2, 3, 5, 4]))
    assert grid.shape == (2, 5, 4, 2)
    # fp32 theta gives a float64 grid in both (the reference's linspace
    # is float64 under jax's x64)
    ref = JF.affine_grid(paddle.to_tensor(theta), [2, 3, 5, 4],
                         align_corners=align_corners)
    assert str(ref._value.dtype) == "float64"
    assert grid.dtype == torch.float64


@pytest.mark.parametrize("fmt, ratio", [("NCHW", 0.25), ("NHWC", 0.2),
                                        ("NCHW", 0.5)])
def test_temporal_shift_matches_reference(fmt, ratio):
    x = _f(np.random.default_rng(4), 6, 8, 3, 4)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    run_case("temporal_shift", [x], dict(seg_num=3, shift_ratio=ratio,
                                         data_format=fmt))


def test_gather_tree_matches_reference():
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 50, (5, 3, 4)).astype(np.int64)
    parents = rng.integers(0, 4, (5, 3, 4)).astype(np.int64)
    want = JF.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(parents))
    got = TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
