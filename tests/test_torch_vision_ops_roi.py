"""The port's RoI ops and deformable convolution
(paddle_tpu_torch/vision/ops.py) against the reference's
(paddle_tpu/vision/ops.py) on the CPU, from the same numpy inputs, fp32.

Each case runs the op in both packages and the backward of ``sum(out *
w)`` (``w`` fixed random weights) through the reference's autograd
(``jax.vjp`` of its primitive) and torch's. Tolerances:
- ``roi_align`` and ``deform_conv2d``: outputs within 1e-5 of their own
  max |value| (absolute below 1), gradients within 1e-4 of their own max
  |g| (the bilinear weights and the products sum in another order);
- ``roi_pool``: the output equal (a max), the gradient within 1e-6 (each
  bin's share summed in fp64 and rounded once; the reference sums in
  fp32);
- ``psroi_pool``: output and gradient within 1e-6 (the port reads each
  bin's sum from an fp64 summed-area table).

The cases cover aligned and unaligned boxes, ``sampling_ratio`` 2 and
-1, several images, boxes over the border and off the map, max ties
(values on a coarse grid) and overlapping bins, ``groups`` /
``deformable_groups`` / no mask, and offsets that put taps off the
border. ``test_backward_runs_no_atomic_scatter_add`` records every aten
op of the backwards (a ``TorchDispatchMode``) and refuses an
accumulating scatter.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.vision import ops as JV

from paddle_tpu_torch.vision import ops as TV

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
POOL_TOL = 1e-6


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


def run_case(fn, inputs, args, kw, grads, out_tol, grad_tol, seed=0):
    """``fn(*inputs, *args, **kw)`` in both packages; the output and the
    gradients of ``sum(out * w)`` into the inputs numbered in
    ``grads``. ``None`` inputs stay ``None``."""
    j_in = [None if a is None else
            paddle.to_tensor(a, stop_gradient=i not in grads)
            for i, a in enumerate(inputs)]
    t_in = [None if a is None else
            torch.from_numpy(a).requires_grad_(i in grads)
            for i, a in enumerate(inputs)]
    j_out = getattr(JV, fn)(*j_in, *args, **kw)
    t_out = getattr(TV, fn)(*t_in, *args, **kw)
    want = np.asarray(j_out._value)
    if out_tol == 0:
        np.testing.assert_array_equal(t_out.detach().numpy(), want)
    else:
        _close(t_out.detach().numpy(), want, out_tol, f"{fn} output")
    w = np.random.default_rng(seed).normal(size=want.shape).astype(
        np.float32)
    (j_out * paddle.to_tensor(w)).sum().backward()
    (t_out * torch.from_numpy(w)).sum().backward()
    for i in grads:
        _close(t_in[i].grad.numpy(), np.asarray(j_in[i].grad._value),
               grad_tol, f"{fn} gradient {i}")


def _maps(rng, *shape, ties=False):
    x = rng.normal(size=shape).astype(np.float32)
    # on a grid of 0.5 and clipped at 0 (a ReLU): many equal maxima
    return np.maximum(np.round(x * 2) / 2, 0).astype(np.float32) if ties \
        else x


def _boxes(rng, n, h, w, scale, over=0.3):
    """``n`` boxes on an ``h x w`` map seen at ``scale``, reaching past
    the border by up to ``over`` of the map."""
    lo = np.array([-over * w, -over * h]) / scale
    hi = np.array([(1 + over) * w, (1 + over) * h]) / scale
    a = rng.uniform(lo, hi, size=(n, 2))
    b = rng.uniform(lo, hi, size=(n, 2))
    return np.concatenate([np.minimum(a, b), np.maximum(a, b)], 1).astype(
        np.float32)


ALIGN_CASES = [
    # (id, x shape, boxes an image, output size, scale, ratio, aligned)
    ("aligned_ratio2", (2, 4, 10, 12), [3, 2], 3, 0.5, 2, True),
    ("unaligned_ratio_default", (2, 3, 9, 11), [1, 4], (2, 3), 0.8, -1,
     False),
    ("aligned_ratio_default_one_image", (1, 5, 12, 8), [5], 4, 1.0, -1,
     True),
    ("unaligned_ratio2_three_images", (3, 2, 7, 9), [2, 0, 3], 2, 0.25, 2,
     False),
]


@pytest.mark.parametrize("case", ALIGN_CASES, ids=[c[0] for c in ALIGN_CASES])
def test_roi_align_matches_reference(case):
    """Output and gradients into x and the boxes."""
    name, shape, num, out, scale, ratio, aligned = case
    rng = np.random.default_rng(len(name))
    x = _maps(rng, *shape)
    boxes = _boxes(rng, sum(num), shape[2], shape[3], scale)
    if not aligned:         # a box under one pixel: rh, rw raised to 1
        boxes[0, 2:] = boxes[0, :2] + 0.4 / scale
    run_case("roi_align", [x, boxes, np.array(num, np.int32)],
             [out, scale, ratio, aligned], {}, (0, 1), OUT_TOL, GRAD_TOL)


POOL_CASES = [
    # (id, x shape, boxes an image, output size, scale, ties)
    ("ties_overlapping_bins", (2, 3, 9, 10), [4, 3], 3, 0.5, True),
    ("several_images", (3, 4, 8, 8), [2, 1, 3], (2, 4), 1.0, False),
    ("coarse_bins_ties", (1, 2, 12, 14), [6], 2, 0.25, True),
    ("fine_bins", (2, 2, 6, 7), [2, 2], 5, 1.0, False),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_roi_pool_matches_reference(case):
    """The max equal, the gradient (ties share it) into x within 1e-6.
    One box lies off the map: its empty bins give 0."""
    name, shape, num, out, scale, ties = case
    rng = np.random.default_rng(len(name) + 1)
    x = _maps(rng, *shape, ties=ties)
    boxes = _boxes(rng, sum(num), shape[2], shape[3], scale)
    boxes[-1] = np.array([shape[3] + 2, 1, shape[3] + 5, 3]) / scale
    run_case("roi_pool", [x, boxes, np.array(num, np.int32)], [out, scale],
             {}, (0,), 0, POOL_TOL)


PSROI_CASES = [
    # (id, output channels, boxes an image, output size, scale)
    ("scale_16th", 2, [3, 2], 3, 1 / 16),
    ("scale_0_8", 3, [1, 4], 2, 0.8),
    ("rect_bins", 1, [4], (2, 3), 0.5),
]


@pytest.mark.parametrize("case", PSROI_CASES, ids=[c[0] for c in PSROI_CASES])
def test_psroi_pool_matches_reference(case):
    """The bins' means and the gradient into x within 1e-6; boxes smaller
    than a pixel take the 0.1 floor on their size."""
    name, oc, num, out, scale = case
    ph, pw = (out, out) if isinstance(out, int) else out
    rng = np.random.default_rng(len(name) + 2)
    h, w = 9, 11
    x = _maps(rng, len(num), oc * ph * pw, h, w)
    boxes = _boxes(rng, sum(num), h, w, scale)
    boxes[0, 2:] = boxes[0, :2] + 0.05 / scale
    run_case("psroi_pool", [x, boxes, np.array(num, np.int32)], [out, scale],
             {}, (0,), POOL_TOL, POOL_TOL)


def test_psroi_pool_channel_check():
    x = torch.zeros(1, 12, 4, 4)
    boxes = torch.tensor([[0.0, 0.0, 3.0, 3.0]])
    with pytest.raises(ValueError, match="divisible by output_size"):
        TV.psroi_pool(x, boxes, torch.tensor([1]), 5)


DEFORM_CASES = [
    # (id, x shape, weight shape, stride, padding, dilation, dg, groups,
    #  mask, bias, offset scale)
    ("groups_dg_mask", (2, 4, 7, 8), (6, 2, 3, 3), 2, 1, 1, 2, 2, True, True,
     1.5),
    ("no_mask_no_bias", (1, 3, 6, 6), (4, 3, 3, 3), 1, 0, 1, 1, 1, False,
     False, 0.7),
    ("dilated_taps_off_border", (2, 2, 6, 5), (3, 2, 2, 3), 1, 2, 2, 1, 1,
     True, True, 4.0),
    ("dg_equals_channels", (1, 4, 5, 5), (2, 2, 3, 3), (2, 1), (1, 0), 1, 4,
     2, True, False, 2.0),
]


@pytest.mark.parametrize("case", DEFORM_CASES,
                         ids=[c[0] for c in DEFORM_CASES])
def test_deform_conv2d_matches_reference(case):
    """Output and gradients into x, offset, mask, weight and bias."""
    (name, xs, ws, stride, padding, dilation, dg, groups, use_mask,
     use_bias, spread) = case
    rng = np.random.default_rng(len(name) + 3)
    kh, kw = ws[2:]
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    oh = (xs[2] + 2 * ph - (dilation * (kh - 1) + 1)) // sh + 1
    ow = (xs[3] + 2 * pw - (dilation * (kw - 1) + 1)) // sw + 1
    x = _maps(rng, *xs)
    weight = _maps(rng, *ws)
    offset = (rng.normal(size=(xs[0], dg * 2 * kh * kw, oh, ow)) * spread
              ).astype(np.float32)
    mask = (rng.uniform(size=(xs[0], dg * kh * kw, oh, ow)).astype(np.float32)
            if use_mask else None)
    bias = _maps(rng, ws[0]) if use_bias else None
    grads = [0, 1, 2] + ([3] if use_bias else []) + ([4] if use_mask else [])
    j_in = [paddle.to_tensor(a, stop_gradient=False) if a is not None
            else None for a in (x, offset, weight, bias, mask)]
    t_in = [torch.from_numpy(a).requires_grad_() if a is not None else None
            for a in (x, offset, weight, bias, mask)]
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              deformable_groups=dg, groups=groups)
    j_out = JV.deform_conv2d(*j_in[:4], mask=j_in[4], **kw)
    t_out = TV.deform_conv2d(*t_in[:4], mask=t_in[4], **kw)
    want = np.asarray(j_out._value)
    _close(t_out.detach().numpy(), want, OUT_TOL, "output")
    w = rng.normal(size=want.shape).astype(np.float32)
    (j_out * paddle.to_tensor(w)).sum().backward()
    (t_out * torch.from_numpy(w)).sum().backward()
    for i in grads:
        _close(t_in[i].grad.numpy(), np.asarray(j_in[i].grad._value),
               GRAD_TOL, f"gradient {i}")


#: aten ops that sum into a tensor through atomics on the card (and
#: ``index_put`` with ``accumulate``, ``scatter_reduce`` with "sum")
ACCUMULATING = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                "embedding_dense_backward", "index_reduce", "index_reduce_",
                "put", "put_"}


class _OpLog(TorchDispatchMode):
    """The accumulating scatters run while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        base = name.split(".")[0]
        if (base in ACCUMULATING
                or ("index_put" in base and (kwargs.get("accumulate") or (
                    len(args) > 3 and args[3] is True)))
                or ("scatter_reduce" in base and "sum" in map(str, args))):
            self.ops.append(name)
        return func(*args, **kwargs)


def test_backward_runs_no_atomic_scatter_add():
    """Every gathering backward (the three RoI ops, ``deform_conv2d``,
    ``yolo_loss``) sums through sorted row sums: no aten op of the
    backward accumulates by scatter, where the card would add with
    atomics in an order that changes from run to run. Overlapping bins,
    repeated taps and two ground truths on one cell make the sums real."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_maps(rng, 2, 6, 9, 10, ties=True))
    boxes = torch.from_numpy(_boxes(rng, 5, 9, 10, 0.5))
    num = torch.tensor([3, 2])
    w = torch.from_numpy(_maps(rng, 4, 6, 3, 3))
    off = torch.from_numpy(rng.normal(size=(2, 18, 9, 10)).astype(
        np.float32))
    gt = torch.tensor([[[0.3, 0.3, 0.2, 0.3], [0.32, 0.31, 0.25, 0.2]],
                       [[0.6, 0.5, 0.4, 0.4], [0.0, 0.0, 0.0, 0.0]]])
    head = torch.from_numpy(rng.normal(size=(2, 2 * 7, 4, 4)).astype(
        np.float32))
    calls = {
        "roi_align": (x, lambda a: TV.roi_align(a, boxes, num, 3, 0.5)),
        "roi_pool": (x, lambda a: TV.roi_pool(a, boxes, num, 3, 0.5)),
        "psroi_pool": (x[:, :4],
                       lambda a: TV.psroi_pool(a, boxes, num, 2, 0.5)),
        "deform_conv2d": (x, lambda a: TV.deform_conv2d(a, off, w,
                                                        padding=1)),
        "yolo_loss": (head, lambda a: TV.yolo_loss(
            a, gt, torch.zeros(2, 2, dtype=torch.int64), [10, 13, 16, 30],
            [0, 1], 2, 0.7, 32)),
    }
    # the log sees the autograd engine's own ops: a plain gather's
    # backward accumulates
    leaf = x.clone().requires_grad_()
    log = _OpLog()
    with log:
        leaf[torch.tensor([0, 0, 1])].sum().backward()
    assert log.ops, "the dispatch log missed the gather's backward"
    for name, (value, call) in calls.items():
        leaf = value.clone().requires_grad_()
        out = call(leaf)
        log = _OpLog()
        with log:
            out.sum().backward()
        assert leaf.grad is not None and leaf.grad.abs().sum() > 0, name
        assert not log.ops, (name, log.ops)
