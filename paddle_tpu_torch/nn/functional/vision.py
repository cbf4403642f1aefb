"""Vision-geometry functional ops: ``affine_grid``, ``grid_sample``,
``temporal_shift`` and ``gather_tree``.

Counterpart of ``paddle_tpu/nn/functional/vision.py``, with its own
sampling rules rather than torch's ``grid_sample`` (plain torch; the
reference composes them in XLA):

- ``affine_grid``: the output grid's normalised coordinates (the
  corners at -1 and 1 with ``align_corners``, else the pixel centres),
  times ``theta`` [N, 2, 3], in fp32.
- ``grid_sample``: grid coordinates unnormalised (``(g + 1) / 2 * (size
  - 1)`` with ``align_corners``, else ``((g + 1) * size - 1) / 2``);
  ``border`` clips them to the input, ``reflection`` reflects them about
  the corners (``align_corners``) or the edges (then clips); ``nearest``
  rounds half to even; ``bilinear`` mixes the four neighbours, and a
  neighbour outside the input reads 0. The neighbours are gathered as
  rows of the NHWC input through ``_Embedding``, so the input's gradient
  is a deterministic row sum, not a scatter-add.
- ``temporal_shift``: per sample of ``seg_num`` frames, the first
  ``shift_ratio`` of the channels move one frame back, the next as many
  one frame forward, zeros at the ends.
- ``gather_tree``: beam-search backtrace over ``[T, B, beam]`` on the
  device, from the last step to the first (the reference does it in
  numpy on the host).
"""
from __future__ import annotations

import torch

from .common import _Embedding

__all__ = ["affine_grid", "grid_sample", "temporal_shift", "gather_tree"]


def _linspace(size, align_corners, device):
    if align_corners:
        return torch.linspace(-1.0, 1.0, size, device=device)
    step = 2.0 / size
    return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                          device=device)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta`` [N, 2, 3] -> sampling grid [N, H, W, 2] (x, y) for
    ``out_shape`` ``[N, C, H, W]``."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    n, _, h, w = (int(v) for v in out_shape)
    dev = theta.device
    gy, gx = torch.meshgrid(_linspace(h, align_corners, dev),
                            _linspace(w, align_corners, dev), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    grid = torch.einsum("hk,nrk->nhr", base, theta.float())
    return grid.reshape(n, h, w, 2)


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _reflect(x, lo, hi):
    rng = hi - lo
    if rng <= 0:
        return torch.zeros_like(x)
    x = torch.remainder(x - lo, 2 * rng)
    return torch.where(x > rng, 2 * rng - x, x) + lo


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` [N, C, H, W] at ``grid`` [N, Hg, Wg, 2] -> [N, C, Hg,
    Wg] (see the module docstring for the rules)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    n, c, h, w = x.shape
    gx = _unnormalize(grid[..., 0].float(), w, align_corners)
    gy = _unnormalize(grid[..., 1].float(), h, align_corners)
    if padding_mode == "border":
        gx, gy = gx.clamp(0, w - 1), gy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        if align_corners:
            gx, gy = _reflect(gx, 0, w - 1), _reflect(gy, 0, h - 1)
        else:
            gx = _reflect(gx, -0.5, w - 0.5).clamp(0, w - 1)
            gy = _reflect(gy, -0.5, h - 0.5).clamp(0, h - 1)
    table = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = (torch.arange(n, device=x.device) * (h * w)).reshape(n, 1, 1)

    def sample(ix, iy):
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ids = base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        vals = _Embedding.apply(table, ids.reshape(-1), None)
        vals = vals.reshape(*ids.shape, c)
        return torch.where(ok[..., None], vals, 0.0)

    if mode == "nearest":
        out = sample(torch.round(gx).long(), torch.round(gy).long())
    else:
        x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
        wx, wy = gx - x0, gy - y0
        out = (sample(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
               + sample(x0 + 1, y0) * (wx * (1 - wy))[..., None]
               + sample(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
               + sample(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.permute(0, 3, 1, 2).to(x.dtype)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM's shift over ``[N * seg_num, C, H, W]`` (or NHWC)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    if data_format == "NHWC":
        return temporal_shift(x.permute(0, 3, 1, 2), seg_num, shift_ratio
                              ).permute(0, 2, 3, 1)
    nt, c, h, w = x.shape
    seg = int(seg_num)
    v = x.reshape(nt // seg, seg, c, h, w)
    fold = int(c * float(shift_ratio))
    zeros = torch.zeros_like(v[:, :1, :fold])
    back = torch.cat([v[:, 1:, :fold], zeros], dim=1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                     v[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([back, fwd, v[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)


def gather_tree(ids, parents):
    """Beam-search backtrace: ``ids`` and ``parents`` [T, B, beam] -> the
    full token path ending in each final beam, [T, B, beam]."""
    t_len, b, beam = ids.shape
    out = torch.empty_like(ids)
    idx = torch.arange(beam, device=ids.device).expand(b, beam)
    for t in range(t_len - 1, -1, -1):
        out[t] = ids[t].gather(1, idx)
        idx = parents[t].long().gather(1, idx)
    return out
