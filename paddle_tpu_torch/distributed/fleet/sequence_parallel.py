"""Megatron sequence parallelism: ``ScatterOp``, ``GatherOp``,
``AllGatherOp``, ``ReduceScatterOp``, the parameter marks,
``register_sequence_parallel_allreduce_hooks`` and the
``Column``/``RowSequenceParallelLinear`` layers.

Counterpart of ``paddle_tpu/distributed/fleet/sequence_parallel.py``
(Paddle's ``fleet/utils/sequence_parallel_utils.py``). Between
tensor-parallel regions each mp rank holds its chunk of the sequence
(dim ``SEQ_DIM`` = 1 of ``[b, s, h]``, as the reference's); the ops move
activations in and out with explicit collectives:

- ``ScatterOp``: this rank's chunk; backward all-gathers.
- ``GatherOp``: all-gather; backward keeps this rank's chunk.
- ``AllGatherOp``: all-gather; backward reduce-scatters (the input of a
  column-parallel layer, whose gradient is a partial sum on each rank).
- ``ReduceScatterOp``: reduce-scatter; backward all-gathers (the output
  of a row-parallel layer).

A parameter used on sequence chunks (a norm between the regions) gets a
partial gradient on each rank: ``mark_as_sequence_parallel_parameter``
marks it and ``register_sequence_parallel_allreduce_hooks`` all-reduces
the marked parameters' gradients over mp after each backward.
"""
from __future__ import annotations

import torch

from ..communication import functional as cf
from .mp_layers import (ColumnParallelLinear, RowParallelLinear, _degree,
                        _mp_group)

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "mark_as_sequence_parallel_parameter",
           "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "SEQ_DIM"]

SEQ_DIM = 1


def ScatterOp(x, axis=SEQ_DIM, group=None):
    return cf.split(x, _mp_group(group), axis)


def GatherOp(x, axis=SEQ_DIM, group=None):
    return cf.gather(x, _mp_group(group), axis)


def AllGatherOp(x, axis=SEQ_DIM, group=None):
    return cf.all_gather(x, _mp_group(group), axis)


def ReduceScatterOp(x, axis=SEQ_DIM, group=None):
    return cf.reduce_scatter(x, _mp_group(group), axis)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.is_sequence_parallel = True


def is_sequence_parallel_parameter(parameter):
    return getattr(parameter, "is_sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(
        model, fuse_sequence_parallel_allreduce=False, group=None):
    """All-reduce the gradient of every marked parameter of ``model`` over
    mp once it is accumulated (a post-accumulate-grad hook each; Paddle's
    fused variant buckets them, which changes no value)."""
    group = _mp_group(group)
    if _degree(group) == 1:
        return model

    def hook(p):
        torch.distributed.all_reduce(p.grad, group=group.process_group)

    for p in model.parameters():
        if is_sequence_parallel_parameter(p):
            p.register_post_accumulate_grad_hook(hook)
    return model


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input arrives sequence-sharded: it
    all-gathers the sequence (``AllGatherOp``) and keeps its output
    features sharded unless ``gather_output``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         gather_output, fuse_matmul_bias, mp_group, name,
                         device, dtype)

    def enter(self, x):
        """The sequence all-gathered (its gradient reduce-scattered)."""
        return AllGatherOp(x, group=self.mp_group)


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output leaves sequence-sharded: the
    partial products are reduce-scattered over the sequence
    (``ReduceScatterOp``), then the bias is added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         input_is_parallel, fuse_matmul_bias, mp_group, name,
                         device, dtype)
        if self.bias is not None:
            # added to sequence chunks: a partial gradient on each rank
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if not self.input_is_parallel:
            x = cf.split(x, self.mp_group, -1)
        out = ReduceScatterOp(torch.nn.functional.linear(x, self.weight),
                              group=self.mp_group)
        return out if self.bias is None else out + self.bias
