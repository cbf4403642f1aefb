"""Group-sharded (ZeRO) data parallelism: ``group_sharded_parallel`` and
``save_group_sharded_model``.

Counterpart of ``paddle_tpu/distributed/sharding/__init__.py``. The
reference lays states, gradients and parameters out ``Shard(0)`` on a
``sharding`` mesh axis and lets XLA emit ZeRO's collectives; here each
rank is a process and the collectives are explicit
(``auto_parallel.api``'s ``shard_optimizer`` stages):

- ``"os"`` (ZeRO-1): the model in ``DataParallel`` over the axis (the
  gradients averaged in the backward), the optimizer's states sharded
  by rows, the updated rows all-gathered after the step;
- ``"os_g"`` (ZeRO-2): the model in ``GroupShardedStage2`` (no
  collective in the backward); at the step each rank's gradient rows
  are the mean over the axis by a reduce-scatter, then as ``"os"``;
- ``"p_g_os"`` (ZeRO-3): the parameters sharded between steps as well
  and the model in ``GroupShardedStage3``, which gathers each for its
  module's forward and again for its backward, and frees it after each
  use (``fleet/meta_parallel/sharding``).

A tensor whose dim 0 the axis does not divide stays replicated, its
gradient averaged whole, as in the reference. At one rank on the axis
nothing is sharded and the model and optimizer come back as they were.
``offload``, the buffer and segment sizes and ``sync_comm`` are
accepted and ignored, as in the reference.
"""
from __future__ import annotations

import os

import torch

from ..auto_parallel.api import (DistParameter, ShardingStage1,
                                 ShardingStage2, ShardingStage3, gather_rows,
                                 shard_optimizer)
from ..auto_parallel.api import restore_param_layouts  # noqa: F401
from ..auto_parallel.placement import ProcessMesh
from ..communication.group import axis_group

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = ("os", "os_g", "p_g_os")
_STAGES = {"os": ShardingStage1, "os_g": ShardingStage2,
           "p_g_os": ShardingStage3}


def _resolve_mesh_axis(model, group):
    """The (mesh, axis) the shards live on: an explicit group's mesh axis;
    else the parameters' mesh if it has a ``sharding`` or ``dp`` axis;
    else the hybrid group's ``sharding`` axis if its degree is above 1;
    else a one-axis ``sharding`` mesh over every rank."""
    from .. import env
    from ..fleet.topology import get_hybrid_communicate_group

    if group is not None and getattr(group, "mesh", None) is not None:
        return group.mesh, group.axis_name
    for p in model.parameters():
        if isinstance(p, DistParameter):
            for axis in ("sharding", "dp"):
                if axis in p.process_mesh.dim_names:
                    return p.process_mesh, axis
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        return hcg.mesh, "sharding"
    return ProcessMesh(list(range(env.get_world_size())),
                       ["sharding"]), "sharding"


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """ZeRO at ``level`` ``"os"``, ``"os_g"`` or ``"p_g_os"`` over
    ``group``'s mesh axis or the resolved one (module docstring).
    Returns (model, optimizer, scaler): the model wrapped for the level
    (``state_dict`` and ``parameters`` are the wrapped layer's), the
    optimizer itself, sharded in place."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    mesh, axis = _resolve_mesh_axis(model, group)
    shard_optimizer(optimizer, _STAGES[level](axis, mesh=mesh))
    g = axis_group(mesh, axis)
    if g.nranks == 1:
        return model, optimizer, scaler
    if level == "os":
        from ..parallel_wrapper import DataParallel

        model = DataParallel(model, group=g)
    else:
        from ..fleet.meta_parallel.sharding import (GroupShardedStage2,
                                                    GroupShardedStage3)

        wrap = GroupShardedStage2 if level == "os_g" else GroupShardedStage3
        model = wrap(model, optimizer, group=g)
    return model, optimizer, scaler


def _whole(t, pg, n):
    whole = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    torch.distributed.all_gather_into_tensor(whole, t.detach().contiguous(),
                                             group=pg)
    return whole


def _whole_optimizer_state(optimizer):
    """``optimizer.state_dict()`` with every state and master of a
    row-sharded or ZeRO-3 parameter all-gathered whole (on every rank,
    in the same order)."""
    sd = optimizer.state_dict()
    rows = getattr(optimizer, "_row_shards", None)
    if rows is None:
        return sd
    names = optimizer._names()
    parts = {id(v) for _, v in rows.views.values()} | rows.sharded
    stores = [(f"__{a}", s) for a, s in optimizer._accumulators.items()]
    stores.append(("__master", optimizer._master_weights))
    for suffix, store in stores:
        for pid, t in store.items():
            if pid in parts:
                sd[names[pid] + suffix] = _whole(t, rows.group,
                                                 rows.nranks)
    return sd


def save_group_sharded_model(model, output: str, optimizer=None) -> None:
    """Save the whole (unsharded) model to ``output/model.pdparams`` and,
    with ``optimizer``, its whole states to ``output/model.pdopt``
    (``paddle.save``'s format). Every rank gathers (a collective); the
    first rank of the sharding group writes, and the others wait for
    it."""
    from ... import framework

    layer = getattr(model, "_layers", model)
    params = dict(layer.named_parameters())
    state = {}
    for name, t in layer.state_dict().items():
        p = params.get(name)
        if p is not None and "_zero3" in p.__dict__:
            t = gather_rows(p, differentiable=False)
        elif isinstance(p, DistParameter):
            t = p.full_tensor()
        state[name] = t.detach()
    opt_state = None if optimizer is None else \
        _whole_optimizer_state(optimizer)
    rows = getattr(optimizer, "_row_shards", None) if optimizer else None
    pg = rows.group if rows is not None else None
    first = (not torch.distributed.is_initialized()
             or torch.distributed.get_rank(pg) == 0)
    if first:
        os.makedirs(output, exist_ok=True)
        framework.save(state, os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            framework.save(opt_state, os.path.join(output, "model.pdopt"))
    if torch.distributed.is_initialized():
        torch.distributed.barrier(group=pg)
