"""Common functional ops: ``linear``, ``dropout``, ``embedding`` and
``one_hot``.

Counterpart of those four functions of
``paddle_tpu/nn/functional/common.py``; the rest of that module waits for
the rest of ``ROADMAP.md`` queue A item 2. The reference composes them
in XLA, so here they are plain torch.

- ``linear`` takes paddle's ``[in, out]`` weight: ``x @ weight + bias``.
- ``dropout`` has paddle's ``axis`` (one mask shared along the other
  axes), both ``mode``s and the ``p == 1`` case. Its keep mask is drawn
  from an explicit ``generator=`` announced through
  ``core.generator.use_generator``, so a recompute region replays the
  same mask. Masks are the port's own stream, not ``jax.random``'s.
- ``embedding`` zeroes the rows of ``padding_idx`` in the output and
  gives that row of the weight no gradient; the gradient is summed in
  fp32 or wider and rounded once to the weight's dtype, as the
  reference's ``_embedding_vjp``. Ids out of range raise the reference's
  ``ValueError`` (one read of their extrema, skipped while a CUDA graph
  is being captured). The gradient's row sums are deterministic
  (``_row_sums``: no atomics), so a step gives the same bits every run
  and a captured step equals an eager one; ``torch.nn.Embedding``'s CUDA
  backward does not, where an id repeats thousands of times (BERT's
  token types). ``Embedding`` is ``torch.nn.Embedding`` on this
  function, without the host read of the bounds, for the models.
- ``one_hot`` returns float32, as the reference's ``one_hot_p``.
"""
from __future__ import annotations

import torch

from ...core.generator import use_generator

__all__ = ["linear", "dropout", "embedding", "one_hot", "Embedding"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (paddle's
    layout)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero each entry (or, with ``axis``, each slice along the other
    axes) with probability ``p``. ``mode="upscale_in_train"`` scales the
    kept entries by ``1 / (1 - p)`` in training and leaves inference
    alone; ``"downscale_in_infer"`` keeps them as they are in training
    and scales by ``1 - p`` in inference. ``p == 1`` gives zeros. A draw
    needs ``generator``."""
    p = float(p)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout draws a keep mask: pass generator= (a "
                         "torch.Generator on the input's device)")
    if axis is None:
        shape = x.shape
    else:
        axes = {int(a) % x.ndim for a in
                ((axis,) if isinstance(axis, int) else axis)}
        shape = tuple(n if i in axes else 1 for i, n in enumerate(x.shape))
    keep = torch.rand(shape, generator=use_generator(generator),
                      device=x.device) < (1.0 - p)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def _row_sums(ids, rows, num, dtype):
    """``out[i] = sum of rows[t] where ids[t] == i`` ([num, D] in
    ``dtype``), deterministically: the rows in id order (a stable sort),
    their fp64 prefix sums along the tokens (a scan, on the transposed
    copy so it runs along the inner axis), and each id's sum the
    difference of the prefix sums at its run's ends, written once to its
    row (the other positions write a spare row, dropped). fp64 prefix
    sums of fp32 values err by about 1e-16 of the whole sum, far below
    one rounding to fp32."""
    t, d = rows.shape
    if t == 0:
        return torch.zeros(num, d, dtype=dtype, device=rows.device)
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    csum = rows[order].to(torch.float64).t().contiguous().cumsum(dim=1)
    csum = torch.cat([csum.new_zeros(d, 1), csum], dim=1)       # [D, T + 1]
    pos = torch.arange(t, device=ids.device)
    edge = sid[1:] != sid[:-1]
    true = torch.ones(1, dtype=torch.bool, device=ids.device)
    first = torch.cat([true, edge])
    last = torch.cat([edge, true])
    start = torch.where(first, pos, 0).cummax(dim=0).values
    sums = (csum[:, pos + 1] - csum[:, start]).t().to(dtype)
    out = torch.zeros(num + 1, d, dtype=dtype, device=rows.device)
    out.index_put_((torch.where(last, sid, num),), sums)
    return out[:num]


class _Embedding(torch.autograd.Function):
    """Row gather whose weight gradient is the deterministic row sum of
    the output gradient (``_row_sums``, fp64 prefix sums) rounded once to
    the weight's dtype; padding ids give zero rows and send no
    gradient."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        out = weight[ids]
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx)[..., None], 0)
        ctx.save_for_backward(ids)
        ctx.padding_idx = padding_idx
        ctx.weight_shape, ctx.weight_dtype = weight.shape, weight.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        if ctx.padding_idx is not None:
            grad = grad.masked_fill((ids == ctx.padding_idx)[..., None], 0)
        gw = _row_sums(ids.reshape(-1), grad.reshape(-1, grad.shape[-1]),
                       ctx.weight_shape[0], ctx.weight_dtype)
        return gw, None, None


def _check_bounds(ids, n):
    if (ids.numel() == 0 or (ids.is_cuda and
                             torch.cuda.is_current_stream_capturing())):
        return
    lo, hi = (int(e) for e in torch.stack([ids.min(), ids.max()]).tolist())
    if lo < 0 or hi >= n:
        raise ValueError(
            "Variable value (input) of OP(paddle.nn.functional.embedding) "
            f"expected >= 0 and < {n}, but got {lo if lo < 0 else hi}. "
            "Please check input value.")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [num, dim] at the integer ids ``x`` (ids first,
    as paddle). A negative ``padding_idx`` counts from the end."""
    ids = x.long()
    _check_bounds(ids, weight.shape[0])
    pi = None
    if padding_idx is not None:
        pi = int(padding_idx)
        if pi < 0:
            pi += weight.shape[0]
    return _Embedding.apply(weight, ids, pi)


def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]`` with a one at each integer id of
    ``x``. Ids outside ``[0, num_classes)`` raise on the CPU; on the card
    they trip a device assert (no host read, so it runs under capture)."""
    return torch.nn.functional.one_hot(x.long(), int(num_classes)).float()


class Embedding(torch.nn.Embedding):
    """``torch.nn.Embedding`` whose forward is :class:`_Embedding` (the
    deterministic gradient); ids are not read on the host (an id out of
    range trips torch's device-side check)."""

    def forward(self, ids):
        return _Embedding.apply(self.weight, ids.long(), self.padding_idx)
