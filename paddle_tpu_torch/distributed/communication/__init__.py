"""Collective communication.

Counterpart of ``paddle_tpu/distributed/communication/__init__.py``
(after Paddle's ``communication/*.py`` over ``ProcessGroupNCCL``). Each
collective runs on the group's ``torch.distributed`` process group,
NCCL on the card and gloo on the CPU. Before ``init_parallel_env`` a
group has no process group and every collective is the identity of a
one-rank world, as the reference's is at one rank.

The reference's semantics, kept where torch's differ:

- ``reduce`` leaves the reduced value on every rank, not only on
  ``dst`` (the reference's ``reduce`` is ``all_reduce``).
- ``ReduceOp.AVG`` is a sum divided by the group's size on both
  backends; an integer tensor truncates, as the reference's ``astype``
  does. ``PROD`` multiplies.
- ``reduce_scatter`` keeps this rank's chunk of the summed
  concatenation; ``all_to_all`` gives ``out[j]`` on rank ``r`` = rank
  ``j``'s ``in[r]`` (inputs of one shape, as the reference stacks
  them); ``all_to_all_single`` with split sizes raises unless the group
  has one rank; ``gather`` fills ``gather_list`` on ``dst`` only and
  ``broadcast_object_list`` may change the list's length, as there.
- ``sync_op=False`` returns a task whose ``wait()`` finishes the
  collective (an ``AVG``'s division included); otherwise the result is
  in place (or in the output list) on return.

Every collective records ``comm.collective_calls``,
``comm.collective_bytes`` and ``comm.collective_seconds`` labeled by
``op`` and ``group`` while observability is on (the reference's
series). ``send`` / ``recv`` and their kin raise, as the reference's
do; point-to-point comes with the pipeline (ROADMAP.md queue A item 4
(e)). The in-trace helpers (``psum``, ``ppermute``, ...) wait for
item 4 (b).
"""
from __future__ import annotations

import functools
import inspect
import time as _time
from typing import List, Optional

import torch

from ... import observability as _obs
from .group import (  # noqa: F401
    Group, _get_or_create_default_group, destroy_process_group, get_backend,
    get_group, is_initialized, new_group)

__all__ = [
    "all_reduce", "all_gather", "all_gather_object", "all_to_all",
    "all_to_all_single", "reduce_scatter", "broadcast", "reduce", "scatter",
    "gather", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "P2POp", "ReduceOp", "new_group", "get_group", "wait", "barrier",
]

# the reference's series (comm.* is claimed in observability/metrics.py)
_obs_state = _obs.state
_M_COMM_CALLS = _obs.counter(
    "comm.collective_calls",
    "host-level collective API invocations, by op and group")
_M_COMM_BYTES = _obs.counter(
    "comm.collective_bytes",
    "input payload bytes moved through collectives, by op and group")
_M_COMM_SECONDS = _obs.histogram(
    "comm.collective_seconds",
    "host wall seconds inside a collective call (a synchronous call on "
    "the card returns once the work is queued), by op and group")


def _group_label(group) -> str:
    if group is None:
        return "world"
    axis = getattr(group, "axis_name", None)
    return axis if axis else f"g{group.id}"


def _payload_bytes(obj) -> int:
    """Byte size of a collective's input payload: tensors and lists of
    them; 0 for anything else (objects)."""
    if isinstance(obj, (list, tuple)):
        return sum(_payload_bytes(t) for t in obj)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    return 0


def _record_collective(op: str, group, nbytes: int, seconds: float):
    labels = {"op": op, "group": _group_label(group)}
    _M_COMM_CALLS.inc(**labels)
    if nbytes:
        _M_COMM_BYTES.inc(nbytes, **labels)
    _M_COMM_SECONDS.observe(seconds, **labels)
    _obs.emit("comm.collective", seconds=seconds, bytes=nbytes, **labels)


def _instrumented(op: str, payload_arg: int = 0):
    """Record calls / bytes / seconds of each call labeled op and group
    while observability is on; ``payload_arg`` is the positional argument
    whose bytes count. Off: one attribute load and a truth test."""
    def deco(fn):
        payload_name = list(inspect.signature(fn).parameters)[payload_arg]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _obs_state.on:
                return fn(*args, **kwargs)
            group = kwargs.get("group")
            if group is None:
                group = next((a for a in args if isinstance(a, Group)), None)
            payload = (args[payload_arg] if len(args) > payload_arg
                       else kwargs.get(payload_name))
            nbytes = _payload_bytes(payload)
            t0 = _time.perf_counter()
            out = fn(*args, **kwargs)
            _record_collective(op, group, nbytes, _time.perf_counter() - t0)
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    return deco


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    import torch.distributed as dist

    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op]


def _group(group) -> Group:
    return group if group is not None else _get_or_create_default_group()


class _Task:
    """What ``sync_op=False`` returns: ``wait()`` waits for the torch
    work (on the card: the current stream waits for it) and then runs
    what finishes the collective on this rank."""

    def __init__(self, work=None, finish=None):
        self._work, self._finish = work, finish

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._finish is not None:
            finish, self._finish = self._finish, None
            finish()
        return True

    def is_completed(self):
        return self._work is None and self._finish is None


def _average(tensor, n):
    if n > 1:
        if tensor.is_floating_point() or tensor.is_complex():
            tensor.div_(n)
        else:
            tensor.div_(n, rounding_mode="trunc")


def _all_reduce(tensor, op, g, sync_op):
    """The uninstrumented all-reduce (``reduce`` and ``reduce_scatter``
    ride on it); returns the tensor, or a task with ``sync_op=False``."""
    import torch.distributed as dist

    pg = g.process_group
    if pg is None:
        return tensor if sync_op else _Task()
    work = dist.all_reduce(tensor, _torch_op(op), group=pg,
                           async_op=not sync_op)
    finish = (functools.partial(_average, tensor, g.nranks)
              if op == ReduceOp.AVG else None)
    if sync_op:
        if finish is not None:
            finish()
        return tensor
    return _Task(work, finish)


@_instrumented("all_reduce")
def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True):
    """``paddle.distributed.all_reduce``: in place on ``tensor``."""
    return _all_reduce(tensor, op, _group(group), sync_op)


@_instrumented("all_gather", payload_arg=1)
def all_gather(tensor_list: List, tensor, group: Optional[Group] = None,
               sync_op=True):
    """Fills ``tensor_list`` with every rank's ``tensor``."""
    import torch.distributed as dist

    g = _group(group)
    if g.process_group is None:
        outs = [tensor.clone()]
    else:
        outs = [torch.empty_like(tensor) for _ in range(g.nranks)]
        dist.all_gather(outs, tensor.contiguous(), group=g.process_group)
    tensor_list.clear()
    tensor_list.extend(outs)
    return tensor_list


def _gather_objects(obj, g):
    import torch.distributed as dist

    if g.process_group is None:
        return [obj]
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.process_group)
    return out


@_instrumented("all_gather_object", payload_arg=1)
def all_gather_object(object_list: List, obj, group=None):
    objs = _gather_objects(obj, _group(group))
    object_list.clear()
    object_list.extend(objs)
    return object_list


@_instrumented("reduce_scatter", payload_arg=1)
def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """This rank's ``tensor.shape[0]`` rows of the reduced concatenation
    of ``tensor_or_tensor_list``."""
    g = _group(group)
    src = (torch.cat(list(tensor_or_tensor_list), dim=0)
           if isinstance(tensor_or_tensor_list, (list, tuple))
           else tensor_or_tensor_list)
    n = tensor.shape[0]
    if g.process_group is None:
        tensor.copy_(src[:n])
        return tensor
    reduced = _all_reduce(src.clone(), op, g, True)
    me = g.rank
    tensor.copy_(reduced[me * n:(me + 1) * n])
    return tensor


def _assign(dst, value):
    """``dst`` takes ``value`` in place (shape and all, as the
    reference's ``_replace_value`` does)."""
    with torch.no_grad():
        if dst.shape == value.shape:
            dst.copy_(value)
        else:
            dst.set_(value.detach().clone().to(dst.dtype))


@_instrumented("all_to_all", payload_arg=1)
def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """``out[j]`` on rank ``r`` = rank ``j``'s ``in[r]``."""
    import torch.distributed as dist

    g = _group(group)
    if g.process_group is None:
        outs = [t.clone() for t in in_tensor_list]
    else:
        stacked = torch.stack(list(in_tensor_list))
        out = torch.empty_like(stacked)
        dist.all_to_all_single(out, stacked, group=g.process_group)
        outs = list(out.unbind(0))
    out_tensor_list.clear()
    out_tensor_list.extend(outs)
    return out_tensor_list


def _check_single_rank(group, op):
    g = _group(group)
    if g.nranks > 1:
        raise NotImplementedError(
            f"{op} over a {g.nranks}-rank group: variable split sizes are "
            f"not supported, as in the reference; split evenly")


@_instrumented("all_to_all_single", payload_arg=1)
def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None,
                      in_split_sizes=None, group=None, sync_op=True):
    """Rank ``r``'s output is the concatenation over ranks ``j`` of rank
    ``j``'s ``r``-th equal chunk of ``in_tensor``."""
    import torch.distributed as dist

    g = _group(group)
    if out_split_sizes is not None or in_split_sizes is not None:
        _check_single_rank(group, "all_to_all_single(split_sizes)")
    if g.process_group is None or g.nranks == 1:
        _assign(out_tensor, in_tensor)
        return out_tensor
    res = torch.empty_like(in_tensor)
    dist.all_to_all_single(res, in_tensor.contiguous(),
                           group=g.process_group)
    _assign(out_tensor, res)
    return out_tensor


@_instrumented("broadcast")
def broadcast(tensor, src: int = 0, group=None, sync_op=True):
    """Global rank ``src``'s ``tensor`` on every rank, in place."""
    import torch.distributed as dist

    g = _group(group)
    if g.process_group is not None:
        dist.broadcast(tensor, src=src, group=g.process_group)
    return tensor


@_instrumented("broadcast_object_list")
def broadcast_object_list(object_list, src=0, group=None):
    """``object_list`` becomes global rank ``src``'s (its length too)."""
    g = _group(group)
    if g.process_group is not None:
        objs = _gather_objects(list(object_list), g)
        object_list[:] = objs[g.get_group_rank(src)]
    return object_list


@_instrumented("reduce")
def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None,
           sync_op=True):
    """The reduced value on every rank, ``dst`` or not (the reference's
    ``reduce`` is its ``all_reduce``)."""
    return _all_reduce(tensor, op, _group(group), sync_op)


@_instrumented("scatter", payload_arg=1)
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """This rank's entry of global rank ``src``'s ``tensor_list``."""
    import torch.distributed as dist

    g = _group(group)
    if g.process_group is None:
        if tensor_list:
            _assign(tensor, tensor_list[0])
        return tensor
    mine = (None if g.rank != g.get_group_rank(src)
            else [t.contiguous() for t in tensor_list])
    dist.scatter(tensor, mine, src=src, group=g.process_group)
    return tensor


@_instrumented("gather")
def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` appended to ``gather_list`` on global rank
    ``dst``; other ranks' lists stay as they are."""
    g = _group(group)
    parts = []
    all_gather.__wrapped__(parts, tensor, group=g)
    if gather_list is not None and g.rank == g.get_group_rank(dst):
        gather_list.extend(parts)
    return gather_list


def _point_to_point(*args, **kwargs):
    raise NotImplementedError(
        "send / recv / isend / irecv / batch_isend_irecv: point-to-point "
        "communication comes with the pipeline (ROADMAP.md queue A item 4 "
        "(e)); the reference's raise too")


send = recv = isend = irecv = batch_isend_irecv = _point_to_point


class P2POp:
    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until ``tensor``'s pending work on the card is
    done (the reference blocks until the value is ready)."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


@_instrumented("barrier")
def barrier(group=None):
    from .. import env

    env.barrier(group)


def _in_trace(*args, **kwargs):
    raise NotImplementedError(
        "the in-trace collectives (psum, all_gather_in_trace, ppermute, "
        "all_to_all_in_trace) come with placements and model parallelism "
        "(ROADMAP.md queue A item 4 (b))")


psum = all_gather_in_trace = ppermute = all_to_all_in_trace = _in_trace

from . import stream  # noqa: E402,F401
