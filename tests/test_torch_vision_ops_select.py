"""The port's selection ops, layer classes and image I/O
(paddle_tpu_torch/vision/ops.py, paddle_tpu_torch/vision/__init__.py)
against the reference's on the CPU, from the same numpy inputs.

Selections are equal: kept indices, their order, labels, counts and
dtypes (int64 ``nms`` indices, the int32 [R, 1] restore index, int32
counts, float32 [K, 6] ``matrix_nms`` rows), the ``nms_top_k=-1`` and
``keep_top_k=-1`` cuts included. Scores are distinct where the
reference's sort is numpy's unstable ``argsort`` (``matrix_nms``,
``generate_proposals``), whose order among equal scores is its own;
``nms`` sorts stably and is held on equal scores too. Floats that come
through an ``exp`` (``generate_proposals``' boxes, Gaussian
``matrix_nms`` scores) are within 4 fp32 ulps of the largest (a box
edge is a centre less a half-width that went through the ``exp``):
the reference's numpy fp32 ``exp`` is up to 2 ulps off the correctly
rounded value, which the port takes; every other float is equal. The
layer classes run against the reference's layers, ``DeformConv2D`` from
the reference's weights (``convert.load_paddle_tpu_state``).
"""
import numpy as np
import pytest
import torch
from _torch_zoo import one_torch_thread  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu import vision as jvision
from paddle_tpu.vision import ops as JV

from paddle_tpu_torch import load_paddle_tpu_state
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.vision import ops as TV

#: fp32 ulps allowed where an ``exp`` stands between input and output
EXP_ULPS = 4


def _np(t):
    return np.asarray(t._value)


def _ulps_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    tol = EXP_ULPS * np.finfo(np.float32).eps * max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max())


def test_numpy_fp32_exp_ulps():
    """Why floats through an ``exp`` get ``EXP_ULPS``: numpy's fp32 ``exp``
    (the reference's decodes) is up to 2 ulps off the correctly rounded
    value (fp64 ``exp`` rounded once, the port's ``_exp32``)."""
    x = np.random.default_rng(0).uniform(-10, 10, 200_000).astype(np.float32)
    got = np.exp(x).view(np.int32).astype(np.int64)
    want = TV._exp32(torch.from_numpy(x)).numpy().view(np.int32).astype(
        np.int64)
    ulps = np.abs(got - want)
    assert ulps.max() <= EXP_ULPS // 2


def _boxes(rng, n, size=60.0):
    a = rng.uniform(0, size, size=(n, 2))
    return np.concatenate([a, a + rng.uniform(size / 30, size / 2,
                                               size=(n, 2))],
                          1).astype(np.float32)


def _distinct(rng, *shape):
    """Scores in (0, 1), all distinct."""
    n = int(np.prod(shape))
    return ((rng.permutation(n) + rng.uniform(0.1, 0.9, n)) / n).reshape(
        shape).astype(np.float32)


NMS_CASES = [
    # (id, threshold, scores, categories, top_k, equal scores)
    ("no_scores", 0.3, False, None, None, False),
    ("scores", 0.5, True, None, None, False),
    ("categories_top_k", 0.3, True, [2, 0, 1], 9, False),
    ("categories_no_scores", 0.4, False, [1, 0], None, False),
    ("equal_scores", 0.3, True, [0, 1, 2], None, True),
]


@pytest.mark.parametrize("case", NMS_CASES, ids=[c[0] for c in NMS_CASES])
def test_nms_matches_reference(case):
    name, thr, use_scores, cats, top_k, equal = case
    rng = np.random.default_rng(len(name))
    boxes = _boxes(rng, 48)
    scores = (np.round(rng.uniform(size=48) * 4) / 4).astype(np.float32) \
        if equal else _distinct(rng, 48)
    idx = rng.integers(0, 3, 48)
    kw = dict(top_k=top_k, categories=cats)
    want = _np(JV.nms(paddle.to_tensor(boxes), thr,
                      paddle.to_tensor(scores) if use_scores else None,
                      paddle.to_tensor(idx) if cats else None, **kw))
    got = TV.nms(torch.from_numpy(boxes), thr,
                 torch.from_numpy(scores) if use_scores else None,
                 torch.from_numpy(idx) if cats else None, **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_categories_need_the_list():
    with pytest.raises(ValueError, match="categories is required"):
        TV.nms(torch.zeros(2, 4), 0.5, category_idxs=torch.zeros(2))


MATRIX_CASES = [
    # (id, gaussian, background, nms_top_k, keep_top_k, score thr, post thr)
    ("linear_background0", False, 0, 10, 20, 0.3, 0.2),
    ("gaussian_no_background_all", True, -1, -1, 100, 0.2, 0.1),
    ("linear_keep_minus_one", False, -1, 6, -1, 0.5, 0.3),
    ("empty", False, 0, 10, 20, 1.5, 0.1),
]


@pytest.mark.parametrize("case", MATRIX_CASES,
                         ids=[c[0] for c in MATRIX_CASES])
def test_matrix_nms_matches_reference(case):
    """Rows (labels, scores, boxes), image-relative indices and counts;
    the nms_top_k=-1 case drops each class's lowest-scored box."""
    name, gaussian, bg, nms_top_k, keep_top_k, thr, post = case
    rng = np.random.default_rng(len(name))
    bboxes = np.stack([_boxes(rng, 30, 1.0) for _ in range(2)])
    scores = _distinct(rng, 2, 4, 30)
    kw = dict(score_threshold=thr, post_threshold=post, nms_top_k=nms_top_k,
              keep_top_k=keep_top_k, use_gaussian=gaussian,
              gaussian_sigma=0.5, background_label=bg, return_index=True,
              return_rois_num=True)
    j_out, j_idx, j_num = JV.matrix_nms(paddle.to_tensor(bboxes),
                                        paddle.to_tensor(scores), **kw)
    t_out, t_idx, t_num = TV.matrix_nms(torch.from_numpy(bboxes),
                                        torch.from_numpy(scores), **kw)
    want = _np(j_out)
    assert t_out.dtype == torch.float32 and t_out.shape == want.shape
    assert t_idx.dtype == t_num.dtype == torch.int32
    np.testing.assert_array_equal(t_num.numpy(), _np(j_num))
    np.testing.assert_array_equal(t_idx.numpy(), _np(j_idx))
    got = t_out.numpy()
    np.testing.assert_array_equal(got[:, [0, 2, 3, 4, 5]],
                                  want[:, [0, 2, 3, 4, 5]])
    if gaussian:
        _ulps_close(got[:, 1], want[:, 1], "scores")
    else:
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
    if name == "empty":
        assert want.shape == (0, 6)
    # one call returns the rows alone
    only = TV.matrix_nms(torch.from_numpy(bboxes), torch.from_numpy(scores),
                         **dict(kw, return_index=False,
                                return_rois_num=False))
    assert torch.equal(only, t_out)


PROPOSAL_CASES = [
    # (id, pre, post, threshold, min size, pixel offset, images)
    ("two_images", 60, 20, 0.5, 0.1, False, 2),
    ("pixel_offset_min_size", 80, 30, 0.7, 4.0, True, 3),
    ("all_candidates", -1, 1000, 0.6, 0.0, False, 1),
]


@pytest.mark.parametrize("case", PROPOSAL_CASES,
                         ids=[c[0] for c in PROPOSAL_CASES])
def test_generate_proposals_matches_reference(case):
    name, pre, post, thr, min_size, offset, n = case
    rng = np.random.default_rng(len(name))
    a, h, w = 3, 5, 6
    scores = _distinct(rng, n, a, h, w)
    deltas = (rng.normal(size=(n, 4 * a, h, w)) * 0.5).astype(np.float32)
    deltas[0, 2] = 12.0         # var * delta past 10: clamped before exp
    centre = np.stack(np.meshgrid(np.arange(w) * 16 + 8,
                                  np.arange(h) * 16 + 8), -1)[:, :, None]
    size = np.array([16.0, 32.0, 64.0])[None, None, :, None]
    anchors = np.concatenate([centre - size / 2, centre + size / 2], -1)
    anchors = np.broadcast_to(anchors, (h, w, a, 4)).astype(np.float32)
    variances = np.broadcast_to(np.float32([1.0, 1.0, 1.0, 1.0]),
                                (h, w, a, 4)).astype(np.float32)
    img = np.array([[80, 96], [70, 90], [60, 60]], np.float32)[:n]
    kw = dict(pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=thr,
              min_size=min_size, pixel_offset=offset, return_rois_num=True)
    j_rois, j_probs, j_num = JV.generate_proposals(
        *(paddle.to_tensor(v) for v in (scores, deltas, img, anchors,
                                        variances)), **kw)
    t_rois, t_probs, t_num = TV.generate_proposals(
        *(torch.from_numpy(np.ascontiguousarray(v))
          for v in (scores, deltas, img, anchors, variances)), **kw)
    assert t_num.dtype == torch.int32
    np.testing.assert_array_equal(t_num.numpy(), _np(j_num))
    np.testing.assert_array_equal(t_probs.numpy(), _np(j_probs))
    _ulps_close(t_rois.numpy(), _np(j_rois), "rois")
    assert t_rois.dtype == t_probs.dtype == torch.float32
    rois, probs = TV.generate_proposals(
        *(torch.from_numpy(np.ascontiguousarray(v))
          for v in (scores, deltas, img, anchors, variances)),
        **dict(kw, return_rois_num=False))
    assert torch.equal(rois, t_rois) and torch.equal(probs, t_probs)


@pytest.mark.parametrize("with_num", [False, True])
@pytest.mark.parametrize("offset", [False, True])
def test_distribute_fpn_proposals_matches_reference(with_num, offset):
    rng = np.random.default_rng(5)
    rois = _boxes(rng, 40, 700.0)
    rois[3] = [10, 10, 10, 10]          # empty: the lowest level
    num = np.array([25, 15], np.int32)
    args = (2, 5, 4, 224)
    j_outs, j_restore, j_nums = JV.distribute_fpn_proposals(
        paddle.to_tensor(rois), *args, pixel_offset=offset,
        rois_num=paddle.to_tensor(num) if with_num else None)
    t_outs, t_restore, t_nums = TV.distribute_fpn_proposals(
        torch.from_numpy(rois), *args, pixel_offset=offset,
        rois_num=torch.from_numpy(num) if with_num else None)
    assert len(t_outs) == len(j_outs) == 4
    for t, j in zip(t_outs, j_outs):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy().reshape(-1, 4),
                                      _np(j).reshape(-1, 4))
    assert t_restore.dtype == torch.int32 and t_restore.shape == (40, 1)
    np.testing.assert_array_equal(t_restore.numpy(), _np(j_restore))
    if with_num:
        for t, j in zip(t_nums, j_nums):
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), _np(j))
    else:
        assert t_nums is None and j_nums is None


def test_layer_classes_match_reference():
    """``RoIAlign``, ``RoIPool`` and ``PSRoIPool`` against the reference's
    layers; ``DeformConv2D`` from the reference layer's weights (names
    and shapes carried by ``load_paddle_tpu_state``), with and without a
    bias."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 9, 10)).astype(np.float32)
    boxes = _boxes(rng, 4, 14.0)
    num = np.array([1, 3], np.int32)
    jx, jb, jn = (paddle.to_tensor(v) for v in (x, boxes, num))
    tx, tb, tn = (torch.from_numpy(v) for v in (x, boxes, num))
    for cls, kw in (("RoIAlign", dict(aligned=False)), ("RoIPool", {}),
                    ("PSRoIPool", {})):
        want = _np(getattr(JV, cls)(2, 0.5)(jx, jb, jn, **kw))
        got = getattr(TV, cls)(2, 0.5)(tx, tb, tn, **kw).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    off = rng.normal(size=(2, 18, 9, 10)).astype(np.float32)
    mask = rng.uniform(size=(2, 9, 9, 10)).astype(np.float32)
    for bias_attr in (None, False):
        paddle.seed(3)
        jl = JV.DeformConv2D(8, 6, 3, padding=1, groups=2,
                             bias_attr=bias_attr)
        tl = TV.DeformConv2D(8, 6, 3, padding=1, groups=2,
                             bias_attr=bias_attr, device="cpu")
        state = {k: _np(v) for k, v in jl.state_dict().items()}
        assert ({k: v.shape for k, v in state.items()}
                == {k: tuple(v.shape) for k, v in tl.state_dict().items()})
        load_paddle_tpu_state(tl, state)
        want = _np(jl(jx, paddle.to_tensor(off), paddle.to_tensor(mask)))
        got = tl(tx, torch.from_numpy(off), torch.from_numpy(mask))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        TV.DeformConv2D(4, 4, 3, weight_attr="w", device="cpu")


def test_read_file_decode_jpeg_and_image_load(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(12, 16, 3)).astype(np.uint8)
    path = tmp_path / "img.jpg"
    Image.fromarray(rgb).save(path, quality=90)
    raw = TV.read_file(str(path), device="cpu")
    j_raw = JV.read_file(str(path))
    assert raw.dtype == torch.uint8
    np.testing.assert_array_equal(raw.numpy(), _np(j_raw))
    for mode in ("unchanged", "gray", "rgb"):
        got = TV.decode_jpeg(raw, mode)
        want = _np(JV.decode_jpeg(j_raw, mode))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    # image_load and the backend setting
    np.save(tmp_path / "a.npy", rgb)
    assert tvision.get_image_backend() == jvision.get_image_backend() == "pil"
    np.testing.assert_array_equal(np.asarray(tvision.image_load(path)),
                                  np.asarray(jvision.image_load(path)))
    for backend in ("numpy", "tensor"):
        for name in ("a.npy", "img.jpg"):
            np.testing.assert_array_equal(
                tvision.image_load(tmp_path / name, backend),
                jvision.image_load(tmp_path / name, backend))
    try:
        tvision.set_image_backend("numpy")
        assert tvision.get_image_backend() == "numpy"
        np.testing.assert_array_equal(tvision.image_load(tmp_path / "a.npy"),
                                      rgb)
    finally:
        tvision.set_image_backend("pil")
    with pytest.raises(ValueError, match="invalid backend"):
        tvision.set_image_backend("gif")
    with pytest.raises(RuntimeError, match="cv2"):
        tvision.image_load(path, "cv2")
