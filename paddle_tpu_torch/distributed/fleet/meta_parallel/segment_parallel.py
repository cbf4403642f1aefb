"""``SegmentParallel``: a model over the ``sep`` axis, each rank on its
chunk of the sequence.

Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/segment_parallel.py``
(Paddle's ``fleet/meta_parallel/segment_parallel.py``). The reference
runs one program: it lays every input out ``Shard(seq_axis)`` over the
sep axis and GSPMD keeps each replicated parameter's gradient whole and
the loss a mean over every token. Here each sep rank is a process that
sees only its chunk, so the wrapper does what that program does for it:

- each tensor input (positional or keyword) is cut to this rank's
  contiguous chunk of ``seq_axis`` (a length that does not divide by
  the sep degree raises ``ValueError``);
- with a ``labels`` keyword, the model's loss (the first output, a mean
  over this rank's labels that are not ``IGNORE_INDEX``, -100 as in the
  models' losses) becomes this rank's share of the mean over the whole
  sequence: it is scaled by its count of such labels over the sep
  group's count, and its value is all-reduced (the backward seeds this
  rank's share alone), so every rank returns the global mean;
- the parameters are broadcast from the group's first rank at
  construction, and after each backward each gradient is summed over
  the sep group (then averaged over ``dp`` when the hybrid group has
  one), in buckets as ``DataParallel`` reduces them: every rank's
  gradient is then the whole sequence's.

Attention inside the model must attend across the chunks
(``fleet.context_parallel``'s ring or Ulysses attention: Llama's
``context_parallel``); everything else is pointwise over the sequence.
``fleet.distributed_model`` wraps a model in this at a ``sep_degree``
above 1, so a user gets both reductions without more code.
"""
from __future__ import annotations

import torch

from ...communication import ReduceOp
from ...communication import functional as cf
from ...parallel_wrapper import _MB, _Reducer, broadcast_state
from ..topology import get_hybrid_communicate_group

__all__ = ["SegmentParallel"]

IGNORE_INDEX = -100


class SegmentParallel(torch.nn.Module):
    """``layers`` on this rank's chunk of the sequence (module
    docstring)."""

    def __init__(self, layers: torch.nn.Module, hcg=None, seq_axis: int = 1,
                 **kwargs):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._seq_axis = seq_axis
        self._group = None
        self._reducer = None
        hcg = self._hcg
        if hcg is None or hcg.get_sep_parallel_world_size() <= 1:
            return
        self._group = hcg.get_sep_parallel_group()
        if self._group.process_group is None:
            return
        reductions = [(self._group, ReduceOp.SUM)]
        if hcg.get_data_parallel_world_size() > 1:
            reductions.append((hcg.get_data_parallel_group(), ReduceOp.AVG))
        for group, _ in reductions:
            broadcast_state(layers, group)
        self._reducer = _Reducer(layers.parameters(), reductions, 25 * _MB,
                                 _MB, find_unused_parameters=False)

    def _chunk(self, t):
        if not isinstance(t, torch.Tensor) or t.ndim <= self._seq_axis:
            return t
        n, rank = self._group.nranks, self._group.rank
        s = t.shape[self._seq_axis]
        if s % n:
            raise ValueError(
                f"SegmentParallel: sequence length {s} must be divisible by "
                f"the sep degree {n}")
        return t.narrow(self._seq_axis, rank * (s // n), s // n)

    def forward(self, *inputs, **kwargs):
        if self._group is None:
            return self._layers(*inputs, **kwargs)
        inputs = tuple(self._chunk(t) for t in inputs)
        kwargs = {k: self._chunk(v) for k, v in kwargs.items()}
        out = self._layers(*inputs, **kwargs)
        labels = kwargs.get("labels")
        if labels is None:
            return out
        loss, *rest = out if isinstance(out, (tuple, list)) else (out,)
        mine = (labels != IGNORE_INDEX).sum().to(loss.dtype)
        total = cf._all_reduce(mine.detach(), self._group.process_group)
        loss = cf.reduce_fwd(loss * (mine / total), self._group)
        return (loss, *rest) if isinstance(out, (tuple, list)) else loss

    # the wrapped layer's surface, as DataParallel's
    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        fn = getattr(self._layers, "set_state_dict",
                     self._layers.load_state_dict)
        return fn(*a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)
