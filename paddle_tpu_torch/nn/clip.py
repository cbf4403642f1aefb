"""Gradient clipping.

Counterpart of ``paddle_tpu/nn/clip.py``: ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm``, which an optimizer
applies to its ``(param, grad)`` pairs before the update, and the
functional ``clip_grad_norm_`` / ``clip_grad_value_`` (the pair
``nn.utils`` exports wraps the same helpers and also honours
``error_if_nonfinite``).

The global-norm clip, the one on the training path, is multi-tensor:
each gradient's norm in one ``torch._foreach_norm`` (``core/foreach.py``:
fp32 on the card, fp64 on the CPU, rounded to fp32), the global norm
and the scale ``clip / max(norm, clip)`` as device tensors, then a
multi-tensor scale (``core/foreach.py::scaled_in_fp32``) that multiplies
in fp32 and rounds back to each gradient's dtype, as the reference does.
A tensor-parallel gradient is a shard: its squares are summed over the
mesh axes it is sharded on (``sharded_global_norm_fp32``), so the norm
is the whole model's on every rank. Nothing is read back to the host, so it runs in a captured step
(``jit.to_static``); ``error_if_nonfinite=True`` reads the norm on the
host and raises ``jit.CaptureError`` there. Like the other two classes
it returns clipped copies and leaves ``p.grad`` alone, as the reference
does; the functions clip ``p.grad`` in place, as the reference's do. As
in the reference, only ``ClipGradByValue`` honours a parameter's
``need_clip = False``.
"""
from __future__ import annotations

import math

import torch

from ..core.foreach import (global_norm_fp32, norm_fp32, scale_in_fp32_,
                            scaled_in_fp32)
from ..jit._capture import no_host_read

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def _dygraph_clip(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _dygraph_clip(self, params_grads):
        return [(p, g) if g is None or getattr(p, "need_clip", True) is False
                else (p, g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an fp32 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            g32 = g.float()
            norm = norm_fp32(g32)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, (g32 * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken over all gradients in fp32."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _scale(self, grads, params):
        """``clip_norm / max(global_norm, clip_norm)``, an fp32 tensor on
        the gradients' device (``params`` tell sharded gradients)."""
        norm = sharded_global_norm_fp32(params, grads)
        return self.clip_norm / torch.clamp(norm, min=self.clip_norm)

    def _dygraph_clip(self, params_grads):
        pairs = [(p, g) for p, g in params_grads if g is not None]
        if not pairs:
            return params_grads
        grads = [g for _, g in pairs]
        clipped = iter(scaled_in_fp32(
            grads, self._scale(grads, [p for p, _ in pairs])))
        return [(p, g if g is None else next(clipped))
                for p, g in params_grads]


def sharded_global_norm_fp32(params, grads):
    """The global norm of ``grads`` where a gradient may be a shard: the
    gradient of a ``distributed.DistParameter`` sharded over mesh
    dimensions of more than one rank is this rank's part, so the sum of
    squares of such gradients is all-reduced over those dimensions, and
    a replicated one is counted once; so is a ZeRO row view's over its
    axis (``auto_parallel.api._norm_groups``). With no such gradient
    (one rank a mesh dimension) it is ``global_norm_fp32(grads)``, the
    same ops."""
    from ..distributed.auto_parallel.api import _norm_groups

    groups: dict = {}
    for p, g in zip(params, grads):
        pgs = _norm_groups(p)
        key = tuple(id(pg) for pg in pgs) or None
        groups.setdefault(key, (pgs, []))[1].append(g)
    if list(groups) == [None]:
        return global_norm_fp32(grads)
    total = None
    for pgs, gs in groups.values():
        sq = global_norm_fp32(gs).square()
        for pg in pgs:
            torch.distributed.all_reduce(sq, group=pg)
        total = sq if total is None else total + sq
    return total.sqrt()


def _grads(parameters):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    return [p.grad for p in parameters if p.grad is not None]


def _clip_grad_norm(parameters, max_norm, norm_type, error_if_nonfinite):
    """Scale the gradients in place to a total ``norm_type`` norm of at
    most ``max_norm`` (coefficient ``min(max_norm / (total + 1e-6), 1)``);
    returns the total before clipping. The inf-norm is taken in the
    gradients' dtype, any other in fp32, as in the reference."""
    grads = _grads(parameters)
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == math.inf:
        total = torch.stack(torch._foreach_norm(grads, math.inf)).max()
    else:
        total = global_norm_fp32(grads, norm_type)
    if error_if_nonfinite:
        no_host_read("clip_grad_norm_(error_if_nonfinite=True)")
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            f"the total norm of gradients is non-finite ({total})")
    scale_in_fp32_(grads, torch.clamp(max_norm / (total + 1e-6), max=1.0))
    return total


def _clip_grad_value(parameters, lo, hi):
    grads = _grads(parameters)
    if grads:
        torch._foreach_clamp_min_(grads, lo)
        torch._foreach_clamp_max_(grads, hi)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """``paddle.nn.clip.clip_grad_norm_``: as the reference's,
    ``error_if_nonfinite`` is accepted and not acted on."""
    return _clip_grad_norm(parameters, max_norm, norm_type, False)


def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients into ``[-clip_value, clip_value]`` in place."""
    _clip_grad_value(parameters, -clip_value, clip_value)
