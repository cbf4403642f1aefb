"""Common functional ops: ``linear``, ``dropout`` and ``embedding``.

Counterpart of those three functions of
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
  fp32 and rounded once to the weight's dtype, as the reference's
  ``_embedding_vjp``. Ids out of range raise the reference's
  ``ValueError`` (one read of their extrema, skipped while a CUDA graph
  is being captured).
"""
from __future__ import annotations

import torch

from ...core.generator import use_generator

__all__ = ["linear", "dropout", "embedding"]


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


class _Embedding(torch.autograd.Function):
    """Row gather whose weight gradient is an fp32 scatter-add rounded
    once to the weight's dtype; padding ids give zero rows and send no
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
        acc = (torch.float32 if ctx.weight_dtype in (torch.bfloat16,
                                                     torch.float16)
               else ctx.weight_dtype)
        gw = torch.zeros(ctx.weight_shape, dtype=acc, device=grad.device)
        gw.index_add_(0, ids.reshape(-1),
                      grad.reshape(-1, grad.shape[-1]).to(acc))
        return gw.to(ctx.weight_dtype), None, None


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
