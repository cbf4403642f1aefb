"""Detection and vision operators: ``paddle.vision.ops`` of the port.

Counterpart of ``paddle_tpu/vision/ops.py``, with its sections and its
``__all__``. The reference composes every op in XLA (gathers, einsums,
``vmap``) or runs it in numpy on the host; no Pallas kernel stands
behind any of them, so here they are plain torch on the tensors' device.
Each op follows the reference's rules, quirks included:

- RoI ops. ``roi_align`` samples a fixed ``n x n`` grid a bin (``n =
  sampling_ratio``, or 2 when it is <= 0, not upstream's adaptive grid)
  with the reference's bilinear edge rule: a sample outside ``(-1, H) x
  (-1, W)`` is 0, the four taps' indices are clamped into the map, the
  weights come from the unclamped floor. ``roi_pool`` rounds the box,
  takes floor / ceil bins and gives 0 for an empty bin; ``psroi_pool``
  floors / ceils unrounded bins of at least 0.1 and averages the bin's
  own channel. The reference builds a dense ``(ph, pw, H, W)`` mask per
  RoI, which no card holds at detection shapes (512 RoIs of 7 x 7 on a
  256 x 50 x 84 map: 2.7e10 elements); the port computes the same
  functions without it: ``roi_align`` gathers only its taps,
  ``roi_pool`` takes the max over a window as tall and wide as the
  largest bin (one host read of those two sizes a call), ``psroi_pool``
  reads each bin's sum from a summed-area table in fp64 (four reads a
  bin, rounded once; the reference's fp32 einsum rounds per term, so the
  two differ by fp32 rounding of the bin's sum).
- Gradients. Every gather's backward sums through
  ``nn.functional.common``'s sorted row sums (``_Embedding``,
  ``_row_sums``): no atomic scatter-add, so a backward gives the same
  bits every run. ``roi_align`` has gradients into ``x`` and the boxes
  (through the bilinear weights), ``deform_conv2d`` into ``x``,
  ``offset``, ``mask``, ``weight`` and ``bias``, ``yolo_loss`` into
  ``x``. A max's gradient is shared equally by the entries that tie
  for it (jax's ``reduce_max`` rule), and a pixel that is the max of
  two overlapping bins gets both gradients.
- Selection ops (``nms``, ``matrix_nms``, ``generate_proposals``,
  ``distribute_fpn_proposals``) compute their IoU and decay matrices,
  sorts and decoding on the device and return tensors there, with the
  reference's dtypes. Their output sizes depend on the data, so each
  reads the host once or twice a call: hard NMS copies
  its ``iou > threshold`` mask to the host in one copy and sweeps it
  there in the reference's order. The exponentials of the decodes are
  taken in fp64 and rounded once, so the card and the CPU give the same
  boxes; numpy's fp32 ``exp`` (the reference's) is up to 2 ulps off the
  rounded value.
"""
from __future__ import annotations

import io
import math

import numpy as np
import torch
from torch import nn

from ..core.place import resolve_device
from ..incubate.nn.layer import _check_attr, _FusedLayer
from ..nn.functional.common import _Embedding, _row_sums

__all__ = [
    "yolo_box", "prior_box", "box_coder", "deform_conv2d", "roi_pool",
    "roi_align", "psroi_pool", "nms", "distribute_fpn_proposals",
    "read_file", "decode_jpeg",
    "RoIAlign", "RoIPool", "PSRoIPool", "DeformConv2D", "matrix_nms",
    "generate_proposals", "yolo_loss",
]


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(s) for s in v)


def _slice_len(k, n):
    """The length of ``a[:k]`` for a sequence of ``n`` (Python slicing:
    a negative ``k`` drops ``-k`` from the end)."""
    return len(range(n)[:k])


def _recip(c):
    """``1 / c`` rounded to fp32. The reference's ops are XLA programs,
    and XLA turns a division by a constant into a product with its fp32
    reciprocal; the port does the same where the reference divides by a
    constant, so that the floor / ceil bin edges, which the rounding can
    move by one, are the reference's."""
    return float(np.float32(1.0) / np.float32(c))


def _exp32(t):
    """``exp`` taken in fp64 and rounded once to ``t``'s dtype: the same
    bits on the card and the CPU."""
    return torch.exp(t.double()).to(t.dtype)


def _on(values, dtype, device):
    """``values`` (a list or numpy array) as a tensor on ``device``: to the
    card from pinned memory, so the host does not wait for the copy."""
    t = torch.as_tensor(values, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _host(*tensors):
    """The tensors as numpy arrays through one device-to-host copy: each
    viewed as bytes, concatenated, copied, and viewed back."""
    flat = [t.contiguous().reshape(-1) for t in tensors]
    buf = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        dt = np.bool_ if t.dtype == torch.bool else t.dtype.__repr__()[6:]
        out.append(buf[at:at + n].view(dt).reshape(tuple(t.shape)))
        at += n
    return out


# --------------------------------------------------------------------------
# RoI ops
# --------------------------------------------------------------------------
def _box_image_index(boxes_num, n, device):
    """The image of each of the ``n`` boxes (int64 [n]), from the boxes'
    count per image, on the device without a host read."""
    counts = torch.as_tensor(boxes_num, device=device).reshape(-1).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), counts, output_size=n)


def _taps(c, size, valid):
    """The two bilinear taps of coordinates ``c`` on an axis of ``size``
    (the reference's ``_bilinear``): indices clamped into the axis
    ([..., 2] int64) and their weights from the unclamped floor
    ([..., 2]), times ``valid``."""
    c0 = torch.floor(c)
    w1 = c - c0
    idx = torch.stack([c0, c0 + 1], -1).clamp(0, size - 1).long()
    wts = torch.stack([1.0 - w1, w1], -1) * valid[..., None]
    return idx, wts


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign of ``x`` [N, C, H, W] over ``boxes`` [R, 4] (x1, y1, x2,
    y2), ``boxes_num`` boxes an image -> [R, C, ph, pw]: each bin the
    mean of ``n x n`` bilinear samples (``n = sampling_ratio``, 2 when
    <= 0). The samples' four taps are rows of the NHWC map gathered
    through ``_Embedding``; the bilinear weights carry the gradient into
    the boxes."""
    ph, pw = _pair(output_size)
    nimg, c, h, w = x.shape
    r = boxes.shape[0]
    img = _box_image_index(boxes_num, r, x.device)
    off = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (boxes[:, k] * spatial_scale - off for k in range(4))
    rh, rw = y2 - y1, x2 - x1
    if not aligned:
        one = torch.ones((), dtype=rh.dtype, device=rh.device)
        rh, rw = torch.maximum(rh, one), torch.maximum(rw, one)
    n = sampling_ratio if sampling_ratio > 0 else 2
    frac = (torch.arange(n, dtype=boxes.dtype, device=x.device) + 0.5) \
        * _recip(n)

    def grid(start, length, bins):
        pos = (torch.arange(bins, dtype=boxes.dtype, device=x.device)[:, None]
               + frac[None, :])
        return (start[:, None, None]
                + pos * (length * _recip(bins))[:, None, None])

    ys, xs = grid(y1, rh, ph), grid(x1, rw, pw)        # [R, ph|pw, n]
    yi, wy = _taps(ys, h, (ys > -1.0) & (ys < h))
    xi, wx = _taps(xs, w, (xs > -1.0) & (xs < w))
    ids = ((img[:, None, None, None, None, None, None] * h
            + yi[:, :, :, :, None, None, None]) * w
           + xi[:, None, None, None, :, :, :])     # [R, ph, n, 2, pw, n, 2]
    table = x.permute(0, 2, 3, 1).reshape(nimg * h * w, c)
    vals = _Embedding.apply(table, ids.reshape(-1), None).reshape(
        *ids.shape, c)
    out = torch.einsum("rpsaqtbc,rpsa,rqtb->rcpq", vals, wy.to(x.dtype),
                       wx.to(x.dtype))
    return out * _recip(n * n)


def _pool_bins(boxes, spatial_scale, ph, pw, h, w, quantize):
    """Each bin's rows ``[y0, y1)`` and columns ``[x0, x1)`` clamped to
    the map (int64 [R, ph] / [R, pw] each), in the reference's fp32
    arithmetic: ``roi_pool`` rounds the box and takes ``start +
    floor(i * size / bins)`` to ``start + ceil((i + 1) * size / bins)``
    with size ``end - start + 1`` (at least 1); ``psroi_pool`` takes
    ``floor(start + i * size / bins)`` to ``ceil(start + (i + 1) * size /
    bins)`` with size at least 0.1. ``/ bins`` is ``* _recip(bins)``, and
    ``end * scale - start`` and ``start + t * _recip(bins)`` are rounded
    once (fused multiply-adds, taken here in fp64), as the reference's
    XLA computes them on the CPU."""
    dev = boxes.device

    def edges(k, bins, size):
        lo = boxes[:, k] * spatial_scale
        i = torch.arange(bins, dtype=boxes.dtype, device=dev)
        r = _recip(bins)
        if quantize:
            lo = torch.round(lo)
            hi = torch.round(boxes[:, k + 2] * spatial_scale)
            length = torch.clamp_min(hi - lo + 1, 1.0)[:, None]
            a = lo[:, None] + torch.floor(i * length * r)
            b = lo[:, None] + torch.ceil((i + 1) * length * r)
        else:
            s32 = float(np.float32(spatial_scale))
            length = torch.clamp_min((boxes[:, k + 2].double() * s32
                                      - lo.double()).to(lo.dtype), 0.1)

            def fma(t):
                return (lo.double()[:, None] + t.double() * r).to(lo.dtype)

            a = torch.floor(fma(i * length[:, None]))
            b = torch.ceil(fma((i + 1) * length[:, None]))
        return a.clamp(0, size).long(), b.clamp(0, size).long()

    return edges(1, ph, h) + edges(0, pw, w)


class _RoIPool(torch.autograd.Function):
    """The max of each bin over a window of ``kh x kw`` (the largest bin)
    from each bin's corner; the backward shares each bin's gradient
    equally among the entries equal to its max and sums them into the
    map through ``_row_sums`` (fp64, rounded once), one window row at a
    time."""

    @staticmethod
    def _window_row(xt, img, bins, i, kw, h, w):
        """Entries of window row ``i`` (``[R, ph, pw, kw, C]``) and
        whether each lies inside its bin, with their rows in ``xt``."""
        y0, y1, x0, x1 = bins
        rows = y0 + i                                  # [R, ph]
        cols = x0[:, :, None] + torch.arange(kw, device=xt.device)
        ok = ((rows < y1)[:, :, None, None]
              & (cols < x1[:, :, None])[:, None, :, :])
        ids = ((img[:, None, None, None] * h
                + rows.clamp(max=h - 1)[:, :, None, None]) * w
               + cols.clamp(max=w - 1)[:, None, :, :])
        return xt[ids], ok, ids

    @staticmethod
    def forward(ctx, x, img, bins, kh, kw):
        nimg, c, h, w = x.shape
        xt = x.permute(0, 2, 3, 1).reshape(nimg * h * w, c)
        r, ph, pw = img.shape[0], bins[0].shape[1], bins[2].shape[1]
        m = torch.full((r, ph, pw, c), -math.inf, dtype=x.dtype,
                       device=x.device)
        for i in range(kh):
            v, ok, _ = _RoIPool._window_row(xt, img, bins, i, kw, h, w)
            v = v.masked_fill(~ok[..., None], -math.inf)
            m = torch.maximum(m, v.amax(dim=3))
        ctx.save_for_backward(x, img, m, *bins)
        ctx.kh, ctx.kw = kh, kw
        return torch.where(torch.isinf(m), 0.0, m).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        x, img, m, *bins = ctx.saved_tensors
        nimg, c, h, w = x.shape
        xt = x.permute(0, 2, 3, 1).reshape(nimg * h * w, c)
        rows = []
        for i in range(ctx.kh):
            v, ok, ids = _RoIPool._window_row(xt, img, bins, i, ctx.kw, h, w)
            rows.append(((v == m[:, :, :, None]) & ok[..., None], ids))
        cnt = sum(eq.sum(dim=3) for eq, _ in rows)
        g = grad.permute(0, 2, 3, 1)
        share = torch.where(torch.isinf(m), 0.0, g / cnt.clamp_min(1))
        total = torch.zeros(nimg * h * w, c, dtype=torch.float64,
                            device=x.device)
        for eq, ids in rows:
            part = torch.where(eq, share[:, :, :, None], 0.0)
            total += _row_sums(ids.reshape(-1), part.reshape(-1, c),
                               nimg * h * w, torch.float64)
        gx = total.to(x.dtype).reshape(nimg, h, w, c).permute(0, 3, 1, 2)
        return gx, None, None, None, None


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoI max pooling of ``x`` [N, C, H, W] -> [R, C, ph, pw] over the
    reference's rounded floor / ceil bins (an empty bin gives 0). The
    window's size, the tallest and widest bin, is read on the host once
    a call; the boxes get no gradient (the reference's bins are integer
    functions of them)."""
    ph, pw = _pair(output_size)
    _, c, h, w = x.shape
    r = boxes.shape[0]
    img = _box_image_index(boxes_num, r, x.device)
    bins = _pool_bins(boxes.detach(), spatial_scale, ph, pw, h, w, True)
    if r == 0:
        return x.new_zeros(0, c, ph, pw)
    kh, kw = (max(int(s), 1) for s in torch.stack(
        [(bins[1] - bins[0]).max(), (bins[3] - bins[2]).max()]).tolist())
    return _RoIPool.apply(x, img, bins, kh, kw)


class _PSRoIPool(torch.autograd.Function):
    """Each bin's mean over its own channel from a summed-area table of
    ``x`` in fp64 (four reads, rounded once). The backward puts each
    bin's ``grad / count`` on the four corners of a table of the same
    shape (``_row_sums``: no atomics) and takes its suffix sums."""

    @staticmethod
    def _corners(x_shape, img, bins, ph, pw):
        """For each bin the flat indices of its four corners in an
        ``[N, H + 1, W + 1, ph, pw]`` table (y1x1, y0x1, y1x0, y0x0:
        [4, R, ph, pw]), and its count of entries."""
        nimg, _, h, w = x_shape
        y0, y1, x0, x1 = bins
        p = torch.arange(ph, device=img.device)[:, None]
        q = torch.arange(pw, device=img.device)[None, :]

        def at(ys, xs):
            return ((((img[:, None, None] * (h + 1) + ys[:, :, None])
                      * (w + 1) + xs[:, None, :]) * ph + p) * pw + q)

        corners = torch.stack([at(y1, x1), at(y0, x1), at(y1, x0),
                               at(y0, x0)])
        cnt = ((y1 - y0)[:, :, None] * (x1 - x0)[:, None, :]).clamp_min(1)
        return corners, cnt

    @staticmethod
    def forward(ctx, x, img, bins, ph, pw):
        nimg, ch, h, w = x.shape
        oc = ch // (ph * pw)
        sat = torch.zeros(nimg, h + 1, w + 1, ph, pw, oc,
                          dtype=torch.float64, device=x.device)
        sat[:, 1:, 1:] = (x.reshape(nimg, oc, ph, pw, h, w)
                          .permute(0, 4, 5, 2, 3, 1).double()
                          .cumsum(1).cumsum(2))
        corners, cnt = _PSRoIPool._corners(x.shape, img, bins, ph, pw)
        v = sat.reshape(-1, oc)[corners]               # [4, R, ph, pw, oc]
        total = v[0] - v[1] - v[2] + v[3]
        ctx.save_for_backward(img, corners, cnt)
        ctx.x_shape, ctx.dtype = x.shape, x.dtype
        return (total / cnt[..., None]).to(x.dtype).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        img, corners, cnt = ctx.saved_tensors
        nimg, ch, h, w = ctx.x_shape
        ph, pw = cnt.shape[1:]
        oc = ch // (ph * pw)
        share = grad.permute(0, 2, 3, 1).double() / cnt[..., None]
        sign = _on([1.0, -1.0, -1.0, 1.0], torch.float64,
                   share.device).reshape(4, 1, 1, 1, 1)
        d = _row_sums(corners.reshape(-1), (sign * share).reshape(-1, oc),
                      nimg * (h + 1) * (w + 1) * ph * pw, torch.float64)
        d = d.reshape(nimg, h + 1, w + 1, ph, pw, oc)
        # x[a, b] is in the table's entries below and right of it
        d = d.flip(1).cumsum(1).flip(1).flip(2).cumsum(2).flip(2)[:, 1:, 1:]
        gx = d.permute(0, 5, 3, 4, 1, 2).reshape(nimg, ch, h, w)
        return gx.to(ctx.dtype), None, None, None, None


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling: ``x`` [N, oc * ph * pw, H, W] ->
    [R, oc, ph, pw], bin (i, j) the mean of channel group (i, j) over the
    bin. The boxes get no gradient (integer bins)."""
    ph, pw = _pair(output_size)
    if x.shape[1] % (ph * pw):
        raise ValueError(
            f"input channel ({x.shape[1]}) must be divisible by "
            f"output_size^2 ({ph * pw})")
    _, _, h, w = x.shape
    img = _box_image_index(boxes_num, boxes.shape[0], x.device)
    bins = _pool_bins(boxes.detach(), spatial_scale, ph, pw, h, w, False)
    return _PSRoIPool.apply(x, img, bins, ph, pw)


# --------------------------------------------------------------------------
# box ops
# --------------------------------------------------------------------------
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Center-size box coding. Encode: priors [P, 4] and targets [T, 4]
    -> [T, P, 4] offsets divided by the variances. Decode: offsets
    ``target_box`` around the priors, which broadcast along ``axis``. A
    list ``prior_box_var`` is broadcast to the priors' shape."""
    if code_type not in ("encode_center_size", "decode_center_size"):
        raise ValueError(f"unknown code_type: {code_type}")
    if isinstance(prior_box_var, (list, tuple)):
        prior_box_var = _on(prior_box_var, torch.float32,
                            prior_box.device).expand(prior_box.shape)
    one = 0 if box_normalized else 1
    if code_type == "encode_center_size":
        pw = prior_box[:, 2] - prior_box[:, 0] + one
        ph = prior_box[:, 3] - prior_box[:, 1] + one
        px = prior_box[:, 0] + pw * 0.5
        py = prior_box[:, 1] + ph * 0.5
        tw = target_box[:, 2] - target_box[:, 0] + one
        th = target_box[:, 3] - target_box[:, 1] + one
        tx = target_box[:, 0] + tw * 0.5
        ty = target_box[:, 1] + th * 0.5
        out = torch.stack([
            (tx[:, None] - px[None, :]) / pw[None, :],
            (ty[:, None] - py[None, :]) / ph[None, :],
            torch.log(tw[:, None] / pw[None, :]),
            torch.log(th[:, None] / ph[None, :]),
        ], dim=-1)
        return out / prior_box_var[None, :, :]
    pb = prior_box.unsqueeze(axis)
    pv = prior_box_var.unsqueeze(axis)
    pw = pb[..., 2] - pb[..., 0] + one
    ph = pb[..., 3] - pb[..., 1] + one
    px = pb[..., 0] + pw * 0.5
    py = pb[..., 1] + ph * 0.5
    d = target_box * pv
    ox = d[..., 0] * pw + px
    oy = d[..., 1] * ph + py
    ow = torch.exp(d[..., 2]) * pw
    oh = torch.exp(d[..., 3]) * ph
    return torch.stack([ox - ow * 0.5, oy - oh * 0.5,
                        ox + ow * 0.5 - one, oy + oh * 0.5 - one], dim=-1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes for the feature map ``input`` over ``image``: two
    [fh, fw, K, 4] float32 tables (boxes, variances) on ``input``'s
    device. They depend only on shapes and the configuration, so they are
    built in numpy as the reference builds them: aspect ratios
    deduplicated (with ``1 / ar`` after each when ``flip``), per min size
    the square, the ratios and ``sqrt(min * max)`` (``min, max, ratios``
    with ``min_max_aspect_ratios_order``)."""
    fh, fw = input.shape[-2], input.shape[-1]
    ih, iw = image.shape[-2], image.shape[-1]
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    whs = []
    for k, ms in enumerate(min_sizes):
        ms = float(ms)
        ar_whs = [(ms * math.sqrt(ar), ms / math.sqrt(ar))
                  for ar in ars if abs(ar - 1.0) >= 1e-6]
        big = [(math.sqrt(ms * float(max_sizes[k])),) * 2] if max_sizes else []
        if min_max_aspect_ratios_order:
            whs += [(ms, ms)] + big + ar_whs
        else:
            whs += [(ms, ms)] + ar_whs + big
    cy = ((np.arange(fh, dtype="float32") + offset) * step_h)[:, None, None]
    cx = ((np.arange(fw, dtype="float32") + offset) * step_w)[None, :, None]
    wh = np.asarray(whs, "float32")
    bw = wh[None, None, :, 0] / 2
    bh = wh[None, None, :, 1] / 2
    boxes = np.stack(np.broadcast_arrays(
        (cx - bw) / iw, (cy - bh) / ih, (cx + bw) / iw, (cy + bh) / ih,
    ), axis=-1).astype("float32")
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, "float32"), boxes.shape)
    return (_on(boxes, torch.float32, input.device),
            _on(var.copy(), torch.float32, input.device))


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLO head ``x`` [N, A * (5 + classes), H, W] (with
    ``iou_aware`` A IoU channels first) into boxes [N, A * H * W, 4] in
    the image's pixels (``img_size`` [N, 2] as h, w) and scores [N, A * H
    * W, classes]. Predictions below ``conf_thresh`` get zero scores and
    zero boxes."""
    n, _, h, w = x.shape
    na = len(anchors) // 2
    an = _on([float(a) for a in anchors], torch.float32,
             x.device).reshape(na, 2)
    if iou_aware:
        ioup = torch.sigmoid(x[:, :na])
        x = x[:, na:]
    x = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    sx, sy = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(x[:, :, 0]) * sx + sy + gx) * _recip(w)
    by = (torch.sigmoid(x[:, :, 1]) * sx + sy + gy) * _recip(h)
    bw = (torch.exp(x[:, :, 2]) * an[None, :, 0, None, None]
          * _recip(downsample_ratio * w))
    bh = (torch.exp(x[:, :, 3]) * an[None, :, 1, None, None]
          * _recip(downsample_ratio * h))
    conf = torch.sigmoid(x[:, :, 4])
    if iou_aware:
        conf = (conf ** (1.0 - iou_aware_factor)
                * ioup ** iou_aware_factor)
    keep = conf >= conf_thresh
    conf = torch.where(keep, conf, 0.0)
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    imh = img_size[:, 0].to(torch.float32)[:, None]
    imw = img_size[:, 1].to(torch.float32)[:, None]
    x1 = (bx - bw / 2).reshape(n, -1) * imw
    y1 = (by - bh / 2).reshape(n, -1) * imh
    x2 = (bx + bw / 2).reshape(n, -1) * imw
    y2 = (by + bh / 2).reshape(n, -1) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = boxes * keep.reshape(n, -1)[..., None]
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return boxes, scores


# --------------------------------------------------------------------------
# deformable convolution
# --------------------------------------------------------------------------
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution (v2 with ``mask``): each kernel tap of each
    output position reads ``x`` bilinearly at its offset position (taps
    off the padded map read 0), times its mask, then the grouped product
    with ``weight`` [Cout, Cin / groups, kh, kw]. The taps are rows of
    the NHWC map per deformable group, gathered through ``_Embedding``;
    the bilinear weights carry the gradient into the offsets."""
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    sh, sw = _pair(stride)
    pad_h, pad_w = _pair(padding)
    dh, dw = _pair(dilation)
    dg, kk = int(deformable_groups), kh * kw
    oh = (h + 2 * pad_h - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pad_w - (dw * (kw - 1) + 1)) // sw + 1
    dev = x.device
    off = offset.reshape(n, dg, kk, 2, oh, ow).permute(0, 1, 4, 5, 2, 3)
    base_y = (torch.arange(oh, device=dev) * sh)[:, None, None]
    base_x = (torch.arange(ow, device=dev) * sw)[None, :, None]
    k_y = torch.repeat_interleave(torch.arange(kh, device=dev) * dh, kw)
    k_x = (torch.arange(kw, device=dev) * dw).repeat(kh)
    # positions on the padded map, as the reference samples it
    ys = (base_y + k_y) + off[..., 0]                  # [n, dg, oh, ow, kk]
    xs = (base_x + k_x) + off[..., 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    ty = torch.stack([y0, y0 + 1]).long() - pad_h      # [2, ...] unpadded
    tx = torch.stack([x0, x0 + 1]).long() - pad_w
    wy = torch.stack([1.0 - wy1, wy1])
    wx = torch.stack([1.0 - wx1, wx1])
    ty, tx = ty[:, None], tx[None, :]          # [2, 1, ...], [1, 2, ...]
    inb = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
    wts = wy[:, None] * wx[None, :] * inb              # [2, 2, n, dg, ...]
    bi = torch.arange(n, device=dev).reshape(n, 1, 1, 1, 1)
    gi = torch.arange(dg, device=dev).reshape(1, dg, 1, 1, 1)
    ids = ((bi * h + ty.clamp(0, h - 1)) * w + tx.clamp(0, w - 1)) * dg + gi
    cpg = cin // dg
    table = x.reshape(n, dg, cpg, h, w).permute(0, 3, 4, 1, 2).reshape(-1, cpg)
    taps = _Embedding.apply(table, ids.reshape(-1), None).reshape(
        *ids.shape, cpg)
    cols = (taps * wts.to(x.dtype)[..., None]).sum(dim=(0, 1))
    if mask is not None:
        cols = cols * mask.reshape(n, dg, kk, oh, ow).permute(
            0, 1, 3, 4, 2)[..., None]
    # [n, dg, oh, ow, kk, cpg] -> [n, groups, Cin / groups, oh, ow, kk]
    cols = cols.permute(0, 1, 5, 2, 3, 4).reshape(n, groups, cin // groups,
                                                  oh, ow, kk)
    wflat = weight.reshape(groups, cout // groups, cin_g, kk)
    out = torch.einsum("ngchwk,gock->ngohw", cols, wflat).reshape(
        n, cout, oh, ow)
    return out if bias is None else out + bias.reshape(1, -1, 1, 1)


# --------------------------------------------------------------------------
# selection ops
# --------------------------------------------------------------------------
def _iou_matrix(b):
    """IoU of every pair of boxes [..., P, 4] -> [..., P, P] in ``b``'s
    dtype, as the reference: areas of clipped widths and heights, the
    union floored at 1e-10."""
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp_min(1e-10)


def _sweep(over, live=None):
    """Hard NMS on the host over ``over`` (numpy bool [P, P], rows and
    columns in sweep order): the positions kept, each one not suppressed
    by a position kept before it; ``live`` (bool [P]) leaves the others
    out."""
    suppressed = np.zeros(over.shape[0], bool) if live is None else ~live
    keep = []
    for i in range(over.shape[0]):
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= over[i]
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Hard NMS over ``boxes`` [N, 4]: int64 indices of the kept boxes,
    by score (stable, highest first; index order without ``scores``).
    IoU in fp64 on the device, a box suppressed by a kept one above
    ``iou_threshold`` (strictly). With ``category_idxs`` the suppression
    is within each category of ``categories`` (a list), the kept boxes
    listed category by category, then sorted by score when ``scores``
    is given. One host read: the ``iou > threshold`` mask."""
    dev = boxes.device
    n = boxes.shape[0]
    over = _iou_matrix(boxes.to(torch.float64)) > iou_threshold
    if scores is None:
        order = torch.arange(n, device=dev)
    else:
        order = torch.argsort(-scores.to(torch.float64), stable=True)
    if category_idxs is not None:
        if categories is None:
            raise ValueError(
                "categories is required when category_idxs is given")
        cats = torch.as_tensor(category_idxs, device=dev).long()
        over &= cats[:, None] == cats[None, :]
        over_h, cats_h = _host(over[order][:, order], cats[order])
        keep = []
        for c in categories:
            members = np.nonzero(cats_h == int(c))[0]
            keep.extend(members[k] for k in _sweep(
                over_h[np.ix_(members, members)]))
    else:
        (over_h,) = _host(over[order][:, order])
        keep = _sweep(over_h)
    keep = order[_on(keep, torch.int64, dev)]
    if category_idxs is not None and scores is not None:
        keep = keep[torch.argsort(-scores.to(torch.float64)[keep],
                                  stable=True)]
    if top_k is not None:
        keep = keep[:int(top_k)]
    return keep


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Assign RoIs [R, 4] to FPN levels by scale: ``floor(log2(sqrt(w *
    h) / refer_scale + 1e-8)) + refer_level`` clipped to the levels (in
    fp64). Returns the RoIs of each level (float32, in their order), the
    int32 [R, 1] index that restores the input order from the levels'
    concatenation, and with ``rois_num`` each level's int32 RoIs an
    image (else None). One host read: the levels' sizes."""
    dev = fpn_rois.device
    rois = fpn_rois.to(torch.float64)
    off = 1.0 if pixel_offset else 0.0
    scale = torch.sqrt((rois[:, 2] - rois[:, 0] + off).clamp_min(0)
                       * (rois[:, 3] - rois[:, 1] + off).clamp_min(0))
    level = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
    level = level.clamp(min_level, max_level).long() - min_level
    nl = max_level - min_level + 1
    order = torch.argsort(level, stable=True)
    sizes = (level[:, None] == torch.arange(nl, device=dev)).sum(0)
    outs = [fpn_rois[idx].to(torch.float32)
            for idx in torch.split(order, sizes.tolist())]
    restore = torch.argsort(order).to(torch.int32)[:, None]
    if rois_num is None:
        return outs, restore, None
    counts = torch.as_tensor(rois_num, device=dev)
    img = _box_image_index(counts, rois.shape[0], dev)
    key = level * counts.numel() + img
    per = (key[:, None] == torch.arange(nl * counts.numel(), device=dev)
           ).sum(0).to(torch.int32).reshape(nl, counts.numel())
    return outs, restore, list(per.unbind(0))


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2) over ``bboxes`` [N, M, 4] and ``scores`` [N,
    C, M]: per image and class (not ``background_label``) the boxes above
    ``score_threshold``, highest first, cut to ``[:nms_top_k]`` (Python
    slicing: -1 drops the last), rescored by their decay (linear, or
    Gaussian with ``gaussian_sigma``) against the boxes above them, each
    suppressor discounted by its own largest overlap above it; rows
    ``[label, score, x1, y1, x2, y2]`` (float32 [K, 6]) of those at least
    ``post_threshold``, each image's sorted by score and cut to
    ``[:keep_top_k]``. Optionally the int32 box indices within the image
    and the int32 rows an image. All on the device, in fp32; two host
    reads (the candidates' counts, the rows' counts)."""
    dev = bboxes.device
    n, c, m = scores.shape
    sc, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    cand = (sc > score_threshold).sum(-1)              # [N, C]
    if nms_top_k >= 0:
        k = cand.clamp(max=nms_top_k)
    else:
        k = (cand + nms_top_k).clamp_min(0)
    if 0 <= background_label < c:
        k[:, background_label] = 0
    kmax = int(k.max()) if k.numel() else 0
    if kmax == 0:
        outs = [bboxes.new_zeros(0, 6, dtype=torch.float32)]
        if return_index:
            outs.append(torch.zeros(0, dtype=torch.int32, device=dev))
        if return_rois_num:
            outs.append(torch.zeros(n, dtype=torch.int32, device=dev))
        return tuple(outs) if len(outs) > 1 else outs[0]
    sc, idx = sc[..., :kmax], idx[..., :kmax]
    live = torch.arange(kmax, device=dev) < k[..., None]   # [N, C, K]
    boxes = torch.gather(bboxes[:, None].expand(n, c, m, 4), 2,
                         idx[..., None].expand(n, c, kmax, 4))
    ious = torch.triu(_iou_matrix(boxes), diagonal=1)
    cmax = ious.max(dim=-2).values
    if use_gaussian:
        decay = _exp32(-(ious * ious - (cmax * cmax)[..., :, None])
                       / gaussian_sigma)
    else:
        floor = torch.full((), 1e-9, dtype=ious.dtype, device=dev)
        decay = (1 - ious) / torch.maximum(1 - cmax, floor)[..., :, None]
    decay = decay.masked_fill(~live[..., :, None], math.inf)
    new_sc = sc * decay.min(dim=-2).values
    post = torch.full((), post_threshold, dtype=new_sc.dtype, device=dev)
    ok = live & (new_sc >= post)
    flat = torch.where(ok, -new_sc, math.inf).reshape(n, c * kmax)
    rank = torch.argsort(flat, dim=-1, stable=True)
    count = ok.reshape(n, -1).sum(-1)
    kept = [_slice_len(keep_top_k, int(v)) for v in count.tolist()]
    sel = _on([i * c * kmax + j for i, q in enumerate(kept)
               for j in range(q)], torch.int64, dev)
    # rank holds positions within an image: add the image's start
    pos = rank.reshape(-1)[sel] + sel // (c * kmax) * (c * kmax)
    label = pos % (c * kmax) // kmax
    out = torch.cat([label[:, None].to(torch.float32),
                     new_sc.reshape(-1)[pos, None].to(torch.float32),
                     boxes.reshape(-1, 4)[pos].to(torch.float32)], dim=1)
    outs = [out]
    if return_index:
        outs.append(idx.reshape(-1)[pos].to(torch.int32))
    if return_rois_num:
        outs.append(_on(kept, torch.int32, dev))
    return tuple(outs) if len(outs) > 1 else out


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals of ``scores`` [N, A, H, W] and ``bbox_deltas`` [N, 4A,
    H, W] around ``anchors`` / ``variances`` [H, W, A, 4]: per image the
    ``pre_nms_top_n`` best, decoded (the size deltas clamped at 10 before
    ``exp``), clipped to the image (``img_size`` [N, 2] as h, w), those
    smaller than ``min_size`` dropped, hard NMS at ``nms_thresh``, the
    first ``post_nms_top_n`` kept. ``pixel_offset`` moves the clip bound
    and the size rule by one pixel. Returns rois [K, 4] and their scores
    [K] (float32), and with ``return_rois_num`` the int32 count an image.
    ``eta`` is ignored, as in the reference. One host read: every image's
    ``iou > nms_thresh`` mask and kept flags."""
    dev = scores.device
    n, a, h, w = scores.shape
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)
    dl = bbox_deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, -1, 4)
    anc = anchors.reshape(-1, 4)
    var = variances.reshape(-1, 4)
    top = _slice_len(pre_nms_top_n, sc.shape[1])
    sc, order = torch.sort(sc, dim=1, descending=True, stable=True)
    sc, order = sc[:, :top], order[:, :top]
    dl = torch.gather(dl, 1, order[..., None].expand(n, top, 4))
    anc, var = anc[order], var[order]                  # [N, top, 4]
    aw = anc[..., 2] - anc[..., 0]
    ah = anc[..., 3] - anc[..., 1]
    acx = anc[..., 0] + aw / 2
    acy = anc[..., 1] + ah / 2
    cx = var[..., 0] * dl[..., 0] * aw + acx
    cy = var[..., 1] * dl[..., 1] * ah + acy
    ten = torch.full((), 10.0, dtype=dl.dtype, device=dev)
    bw = aw * _exp32(torch.minimum(var[..., 2] * dl[..., 2], ten))
    bh = ah * _exp32(torch.minimum(var[..., 3] * dl[..., 3], ten))
    off = 1.0 if pixel_offset else 0.0
    im = img_size.to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    wmax = (im[:, 1] - off)[:, None]
    hmax = (im[:, 0] - off)[:, None]
    x1 = torch.minimum(torch.maximum((cx - bw / 2).double(), zero), wmax)
    y1 = torch.minimum(torch.maximum((cy - bh / 2).double(), zero), hmax)
    x2 = torch.minimum(torch.maximum((cx + bw / 2).double(), zero), wmax)
    y2 = torch.minimum(torch.maximum((cy + bh / 2).double(), zero), hmax)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).to(sc.dtype)
    ok = ((boxes[..., 2] - boxes[..., 0] + off >= min_size)
          & (boxes[..., 3] - boxes[..., 1] + off >= min_size))
    over = _iou_matrix(boxes.to(torch.float64)) > nms_thresh
    over_h, ok_h = _host(over, ok)
    picks, rois_num = [], []
    for i in range(n):
        keep = _sweep(over_h[i], ok_h[i])[:post_nms_top_n]
        picks.extend(i * top + k for k in keep)
        rois_num.append(len(keep))
    picks = _on(picks, torch.int64, dev)
    rois = boxes.reshape(-1, 4)[picks]
    probs = sc.reshape(-1)[picks]
    if return_rois_num:
        return rois, probs, _on(rois_num, torch.int32, dev)
    return rois, probs


def _sce(logit, label):
    """Sigmoid cross-entropy on raw logits (the reference's stable form;
    ``maximum`` so a logit at 0 splits its gradient as jax's does)."""
    zero = torch.zeros((), dtype=logit.dtype, device=logit.device)
    return (torch.maximum(logit, zero) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit))))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss of a head ``x`` [N, len(anchor_mask) * (5 + classes),
    H, W] against ``gt_box`` [N, B, 4] (normalised cx, cy, w, h),
    ``gt_label`` [N, B] and ``gt_score`` -> float32 [N]. Each valid
    ground truth (w, h > 0) goes to its best masked anchor by
    width-height IoU at cell ``(int(cy * H), int(cx * W))``: SCE on the
    raw x / y logits and L1 on w / h, scaled by ``(2 - w * h) * score``;
    the class SCE (smoothing ``min(1 / classes, 1 / 40)``); objectness
    targets the largest score on a cell, and a negative cell whose
    decoded box (``scale_x_y`` here only) overlaps a ground truth above
    ``ignore_thresh`` is ignored. The gathered predictions read through
    ``_Embedding``, so two ground truths on one cell sum their gradients
    without atomics."""
    n, _, h, w = x.shape
    na = len(anchor_mask)
    dev = x.device
    x = x.reshape(n, na, 5 + class_num, h, w).to(torch.float32)
    px = scale_x_y * torch.sigmoid(x[:, :, 0]) - 0.5 * (scale_x_y - 1.0)
    py = scale_x_y * torch.sigmoid(x[:, :, 1]) - 0.5 * (scale_x_y - 1.0)
    obj_logit = x[:, :, 4]
    input_size = downsample_ratio * h
    masked = [(anchors[2 * i], anchors[2 * i + 1]) for i in anchor_mask]
    b = gt_box.shape[1]
    gx = gt_box[:, :, 0] * w
    gy = gt_box[:, :, 1] * h
    gw, gh = gt_box[:, :, 2], gt_box[:, :, 3]
    valid = (gw > 0) & (gh > 0)
    gi = gx.to(torch.int32).clamp(0, w - 1).long()
    gj = gy.to(torch.int32).clamp(0, h - 1).long()
    ious = []
    for aw, ah in masked:
        aw_n, ah_n = aw / input_size, ah / input_size
        inter = gw.clamp(max=aw_n) * gh.clamp(max=ah_n)
        union = gw * gh + aw_n * ah_n - inter
        ious.append(inter / union.clamp_min(1e-9))
    best = torch.argmax(torch.stack(ious, -1), -1)     # [N, B]
    score = gt_score if gt_score is not None else torch.ones_like(gw)
    score = torch.where(valid, score, 0.0)
    tw = torch.zeros_like(gw)
    th = torch.zeros_like(gh)
    for a, (aw, ah) in enumerate(masked):
        sel = best == a
        tw = torch.where(sel, torch.log(
            (gw * input_size * _recip(aw)).clamp_min(1e-9)), tw)
        th = torch.where(sel, torch.log(
            (gh * input_size * _recip(ah)).clamp_min(1e-9)), th)
    bi = torch.arange(n, device=dev)[:, None]
    cell = ((bi * na + best) * h + gj) * w + gi        # [N, B]
    table = x.permute(0, 1, 3, 4, 2).reshape(n * na * h * w, 5 + class_num)
    pred = _Embedding.apply(table, cell.reshape(-1), None).reshape(
        n, b, 5 + class_num)
    box_scale = (2.0 - gw * gh) * score
    l_xy = (_sce(pred[..., 0], gx - gi) + _sce(pred[..., 1], gy - gj)) \
        * box_scale
    l_wh = ((pred[..., 2] - tw).abs() + (pred[..., 3] - th).abs()) \
        * box_scale
    # objectness targets: the largest score on a cell (a max is
    # order-free, so the scatter is deterministic)
    obj_t = torch.zeros(n * na * h * w, dtype=torch.float32, device=dev)
    obj_t = obj_t.scatter_reduce(0, cell.reshape(-1),
                                 score.reshape(-1).to(torch.float32),
                                 "amax").reshape(n, na, h, w)
    with torch.no_grad():
        cell_x = torch.arange(w, device=dev)[None, None, None, :]
        cell_y = torch.arange(h, device=dev)[None, None, :, None]
        pcx = (px + cell_x) * _recip(w)
        pcy = (py + cell_y) * _recip(h)
        aw_t = _on([a[0] for a in masked], torch.int64, dev)[:, None, None]
        ah_t = _on([a[1] for a in masked], torch.int64, dev)[:, None, None]
        pw = _exp32(x[:, :, 2].clamp(-10, 10)) * aw_t * _recip(input_size)
        ph = _exp32(x[:, :, 3].clamp(-10, 10)) * ah_t * _recip(input_size)
        g = [t[:, None, None, None, :] for t in (gt_box[:, :, 0],
                                                 gt_box[:, :, 1], gw, gh)]
        p = [t[..., None] for t in (pcx, pcy, pw, ph)]
        ix = (torch.minimum(p[0] + p[2] / 2, g[0] + g[2] / 2)
              - torch.maximum(p[0] - p[2] / 2, g[0] - g[2] / 2)).clamp_min(0)
        iy = (torch.minimum(p[1] + p[3] / 2, g[1] + g[3] / 2)
              - torch.maximum(p[1] - p[3] / 2, g[1] - g[3] / 2)).clamp_min(0)
        inter = ix * iy
        union = (p[2] * p[3]) + g[2] * g[3] - inter
        pred_iou = torch.where(valid[:, None, None, None, :],
                               inter / union.clamp_min(1e-9), 0.0)
        pos = obj_t > 1e-5
        ignore = (pred_iou.amax(-1) > ignore_thresh) & ~pos
    l_obj_map = torch.where(
        pos, _sce(obj_logit, 1.0) * obj_t,
        torch.where(ignore, 0.0, _sce(obj_logit, 0.0)))
    l_obj = l_obj_map.sum(dim=(1, 2, 3))
    smooth = min(1.0 / class_num, 1.0 / 40.0) if use_label_smooth else 0.0
    lab = gt_label.to(torch.int32).clamp(0, class_num - 1).long()
    cls_t = torch.where(
        torch.arange(class_num, device=dev) == lab[..., None],
        1.0 - smooth, smooth)
    l_cls = (_sce(pred[..., 5:], cls_t).sum(-1) * score).sum(-1)
    return (l_xy + l_wh).sum(-1) + l_obj + l_cls


# --------------------------------------------------------------------------
# image I/O
# --------------------------------------------------------------------------
def read_file(filename, name=None, device=None):
    """The bytes of ``filename`` as a uint8 tensor on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with open(filename, "rb") as f:
        data = bytearray(f.read())
    return torch.frombuffer(data, dtype=torch.uint8).to(dev)


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode the JPEG bytes ``x`` (uint8) on the host through Pillow into
    a uint8 [C, H, W] tensor on ``x``'s device (``mode`` "gray" or "rgb"
    converts first)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decode_jpeg requires Pillow") from e

    img = Image.open(io.BytesIO(x.cpu().numpy().tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None, :, :] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.array(arr)).to(x.device)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
class RoIAlign(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale, aligned=aligned)


class RoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


class PSRoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          self._spatial_scale)


class DeformConv2D(_FusedLayer):
    """``deform_conv2d`` over its own ``weight`` [Cout, Cin / groups, kh,
    kw] (Xavier-normal, as the reference's default) and ``bias`` [Cout]
    (zeros; ``bias_attr=False``: none), on ``device`` (the card unless
    ``"cpu"``) in ``dtype``, drawn from ``seed``. Offsets and masks come
    from the caller. Other ``*_attr`` values raise."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__(device, dtype, seed, None)
        _check_attr("weight_attr", weight_attr)
        _check_attr("bias_attr", bias_attr)
        kh, kw = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        self._param("weight", [out_channels, in_channels // groups, kh, kw])
        self._maybe("bias", [out_channels], bias_attr)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self._stride,
                             self._padding, self._dilation,
                             self._deformable_groups, self._groups, mask)
