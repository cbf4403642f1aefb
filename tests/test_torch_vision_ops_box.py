"""The port's box ops and YOLO loss (paddle_tpu_torch/vision/ops.py:
``box_coder``, ``prior_box``, ``yolo_box``, ``yolo_loss``) against the
reference's (paddle_tpu/vision/ops.py) on the CPU, from the same numpy
inputs, fp32.

Tolerances: outputs within 1e-5 of their own max |value| (absolute below
1: ``exp``, ``log`` and the reference's XLA fusions round differently
from torch's), gradients of ``sum(out * w)`` (``w`` fixed random
weights) within 1e-4 of their own max |g|; ``prior_box``'s tables are
numpy in both packages and equal. ``yolo_loss``'s cases put two ground
truths on one cell, rows of zero width (invalid, weighted 0), a
``gt_score``, label smoothing on and off, and ``scale_x_y``.
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu.vision import ops as JV

from paddle_tpu_torch.vision import ops as TV

OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


def _boxes(rng, n, lo, hi):
    a = rng.uniform(lo, hi, size=(n, 2))
    return np.concatenate([a, a + rng.uniform(1, hi / 2, size=(n, 2))],
                          1).astype(np.float32)


CODER_CASES = [
    # (id, code type, normalized, axis, variance as a list)
    ("encode_list_var", "encode_center_size", True, 0, True),
    ("encode_pixels_tensor_var", "encode_center_size", False, 0, False),
    ("decode_axis0", "decode_center_size", True, 0, True),
    ("decode_axis1_pixels", "decode_center_size", False, 1, False),
]


@pytest.mark.parametrize("case", CODER_CASES, ids=[c[0] for c in CODER_CASES])
def test_box_coder_matches_reference(case):
    """Output and the gradients into the priors and the targets."""
    name, code, normalized, axis, var_list = case
    rng = np.random.default_rng(len(name))
    prior = _boxes(rng, 6, 0, 40)
    var = [0.1, 0.1, 0.2, 0.2] if var_list else rng.uniform(
        0.05, 0.3, size=(6, 4)).astype(np.float32)
    if code == "encode_center_size":
        target = _boxes(rng, 5, 0, 40)
    else:
        shape = (3, 6, 4) if axis == 0 else (6, 3, 4)
        target = rng.normal(size=shape).astype(np.float32)
    jp, jt = (paddle.to_tensor(a, stop_gradient=False)
              for a in (prior, target))
    tp, tt = (torch.from_numpy(a).requires_grad_() for a in (prior, target))
    jv = var if var_list else paddle.to_tensor(var)
    tv = var if var_list else torch.from_numpy(var)
    j_out = JV.box_coder(jp, jv, jt, code, normalized, axis)
    t_out = TV.box_coder(tp, tv, tt, code, normalized, axis)
    want = np.asarray(j_out._value)
    _close(t_out.detach().numpy(), want, OUT_TOL, "output")
    w = rng.normal(size=want.shape).astype(np.float32)
    (j_out * paddle.to_tensor(w)).sum().backward()
    (t_out * torch.from_numpy(w)).sum().backward()
    _close(tp.grad.numpy(), np.asarray(jp.grad._value), GRAD_TOL, "prior")
    _close(tt.grad.numpy(), np.asarray(jt.grad._value), GRAD_TOL, "target")


def test_box_coder_unknown_code_type():
    with pytest.raises(ValueError, match="unknown code_type"):
        TV.box_coder(torch.zeros(1, 4), [0.1] * 4, torch.zeros(1, 4), "x")


PRIOR_CASES = [
    # (id, feature map, image, keyword arguments)
    ("ssd_first_map", (1, 8, 5, 5), (1, 3, 40, 40),
     dict(min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[2.0],
          flip=True, clip=True, steps=[8.0, 8.0])),
    ("dedup_ratios_max_first", (1, 4, 3, 4), (1, 3, 30, 40),
     dict(min_sizes=[10.0, 20.0], max_sizes=[15.0, 30.0],
          aspect_ratios=[1.0, 2.0, 2.0, 3.0], flip=True,
          min_max_aspect_ratios_order=True)),
    ("no_max_offset", (1, 2, 4, 2), (1, 3, 16, 8),
     dict(min_sizes=[4.0], aspect_ratios=[0.5], variance=[0.1, 0.2, 0.3,
                                                          0.4],
          offset=0.25)),
]


@pytest.mark.parametrize("case", PRIOR_CASES, ids=[c[0] for c in PRIOR_CASES])
def test_prior_box_matches_reference(case):
    name, fmap, image, kw = case
    jb, jv = JV.prior_box(paddle.to_tensor(np.zeros(fmap, np.float32)),
                          paddle.to_tensor(np.zeros(image, np.float32)), **kw)
    tb, tv = TV.prior_box(torch.zeros(fmap), torch.zeros(image), **kw)
    assert tb.dtype == tv.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb._value))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv._value))


YOLO_BOX_CASES = [
    # (id, anchors, classes, iou_aware, scale_x_y, clip, conf_thresh)
    ("yolov3_head", [10, 13, 16, 30, 33, 23], 4, False, 1.0, True, 0.3),
    ("ppyolo_scale_no_clip", [30, 61, 62, 45], 3, False, 1.05, False, 0.2),
    ("iou_aware", [10, 13, 16, 30], 2, True, 1.1, True, 0.25),
]


@pytest.mark.parametrize("case", YOLO_BOX_CASES,
                         ids=[c[0] for c in YOLO_BOX_CASES])
def test_yolo_box_matches_reference(case):
    """Boxes and scores, those under ``conf_thresh`` zeroed in both."""
    name, anchors, classes, iou_aware, sxy, clip, thresh = case
    rng = np.random.default_rng(len(name))
    na = len(anchors) // 2
    ch = na * (5 + classes) + (na if iou_aware else 0)
    x = (rng.normal(size=(2, ch, 5, 6)) * 2).astype(np.float32)
    img = np.array([[160, 192], [150, 200]], np.int32)
    kw = dict(anchors=anchors, class_num=classes, conf_thresh=thresh,
              downsample_ratio=32, clip_bbox=clip, scale_x_y=sxy,
              iou_aware=iou_aware, iou_aware_factor=0.4)
    jb, js = JV.yolo_box(paddle.to_tensor(x), paddle.to_tensor(img), **kw)
    tb, ts = TV.yolo_box(torch.from_numpy(x), torch.from_numpy(img), **kw)
    want_b, want_s = np.asarray(jb._value), np.asarray(js._value)
    np.testing.assert_array_equal(tb.numpy() == 0, want_b == 0)
    _close(tb.numpy(), want_b, OUT_TOL, "boxes")
    _close(ts.numpy(), want_s, OUT_TOL, "scores")


def _gt(rng, n, b, classes):
    """Ground truths (cx, cy, w, h normalised), labels and scores: the
    first two of each image share a cell, the last has zero width."""
    box = np.concatenate([rng.uniform(0.1, 0.9, size=(n, b, 2)),
                          rng.uniform(0.05, 0.5, size=(n, b, 2))], -1)
    box[:, 1, :2] = box[:, 0, :2] + 0.01
    box[:, -1, 2] = 0.0
    label = rng.integers(0, classes, size=(n, b)).astype(np.int32)
    score = rng.uniform(0.5, 1.0, size=(n, b)).astype(np.float32)
    return box.astype(np.float32), label, score


YOLO_LOSS_CASES = [
    # (id, anchor mask, classes, smoothing, gt_score, scale_x_y, ignore)
    ("yolov3_stride32", [6, 7, 8], 3, True, False, 1.0, 0.7),
    ("score_no_smoothing", [3, 4, 5], 4, False, True, 1.0, 0.5),
    ("ppyolo_scale", [0, 1, 2], 2, True, True, 1.05, 0.7),
]
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
           198, 373, 326]


@pytest.mark.parametrize("case", YOLO_LOSS_CASES,
                         ids=[c[0] for c in YOLO_LOSS_CASES])
def test_yolo_loss_matches_reference(case):
    """The [N] loss and its gradient into x."""
    name, mask, classes, smooth, use_score, sxy, ignore = case
    rng = np.random.default_rng(len(name))
    h = w = 6
    x = rng.normal(size=(2, len(mask) * (5 + classes), h, w)).astype(
        np.float32)
    box, label, score = _gt(rng, 2, 5, classes)
    kw = dict(anchors=ANCHORS, anchor_mask=mask, class_num=classes,
              ignore_thresh=ignore, downsample_ratio=32,
              use_label_smooth=smooth, scale_x_y=sxy)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    j_loss = JV.yolo_loss(jx, paddle.to_tensor(box), paddle.to_tensor(label),
                          gt_score=paddle.to_tensor(score) if use_score
                          else None, **kw)
    t_loss = TV.yolo_loss(tx, torch.from_numpy(box), torch.from_numpy(label),
                          gt_score=torch.from_numpy(score) if use_score
                          else None, **kw)
    want = np.asarray(j_loss._value)
    assert t_loss.dtype == torch.float32 and t_loss.shape == (2,)
    _close(t_loss.detach().numpy(), want, OUT_TOL, "loss")
    wt = rng.normal(size=want.shape).astype(np.float32)
    (j_loss * paddle.to_tensor(wt)).sum().backward()
    (t_loss * torch.from_numpy(wt)).sum().backward()
    _close(tx.grad.numpy(), np.asarray(jx.grad._value), GRAD_TOL, "grad")
