"""The group-sharded (ZeRO) wrappers: ``GroupShardedOptimizerStage2``,
``GroupShardedStage2`` and ``GroupShardedStage3``.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/sharding``
(Paddle's ``group_sharded_optimizer_stage2.py``,
``group_sharded_stage2.py``, ``group_sharded_stage3.py``). The ZeRO
arithmetic lives in the optimizer (``auto_parallel.api``'s
``shard_optimizer`` stages); these classes are the user's handles:

- ``GroupShardedOptimizerStage2(params, optim, group)``: ``optim``'s
  states sharded by rows over the group's axis, each rank's gradient
  rows the mean over it by a reduce-scatter at the step;
- ``GroupShardedStage2(layer, optimizer)``: the layer as it is (no
  collective in the backward: the stage-2 optimizer averages);
- ``GroupShardedStage3(layer, optimizer, group)``: ZeRO-3. Every
  parameter whose dim 0 the axis divides is this rank's rows between
  steps. While the wrapped model's forward runs (or a module's that owns
  one), reading such a parameter as a module attribute gives the whole
  tensor: it is all-gathered at its first read (``gather_rows``, whose
  backward reduce-scatters the gradient into the shard's and divides it
  by the ranks) and kept until the owning module's forward returns (a
  parameter that another module reads, as a causal LM reads its head's
  weight for the fused loss, until the model's forward returns). The
  ops keep no copy for the backward: while the model's forward runs, a
  saved-tensor hook stores, in place of any tensor whose storage is a
  gathered parameter's, a reference to the shard and the view, and the
  backward all-gathers it again when it unpacks it. So a whole
  parameter lives from its first read to its module's return, and again
  during the backward of each op that saved it.
"""
from __future__ import annotations

import torch
from torch import nn

from ....auto_parallel.api import (ShardingStage2, ShardingStage3,
                                   gather_rows, shard_optimizer)

__all__ = [
    "GroupShardedOptimizerStage2", "GroupShardedStage2", "GroupShardedStage3",
]


class _Params:
    def __init__(self, params):
        self._params = list(params)

    def parameters(self):
        return iter(self._params)


class GroupShardedOptimizerStage2:
    """ZeRO-2 over ``group``'s mesh axis (else the resolved one, as
    ``group_sharded_parallel``'s): ``optim`` sharded in place at stage 2;
    the rest of the optimizer's surface is ``optim``'s. ``offload`` is
    accepted and ignored, as in the reference."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", **kwargs):
        from ....sharding import _resolve_mesh_axis

        mesh, axis = _resolve_mesh_axis(_Params(params), group)
        self._inner_opt = shard_optimizer(optim,
                                          ShardingStage2(axis, mesh=mesh))

    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, *args, **kwargs):
        self.step()

    def clear_grad(self, *args, **kwargs):
        self._inner_opt.clear_grad(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)


class _ShardedLayerWrapper(nn.Module):
    """A layer behind a wrapper: ``forward``, the parameters and the
    state dict are the layer's. Its ranks see different data, so the
    layer's MoE gates route over them (the group's, else the resolved
    sharding axis's), as under ``DataParallel``."""

    def __init__(self, layers: nn.Module, group=None):
        super().__init__()
        self._layers = layers
        if group is None:
            from ....communication.group import axis_group
            from ....sharding import _resolve_mesh_axis

            group = axis_group(*_resolve_mesh_axis(layers, None))
        for m in layers.modules():
            if hasattr(type(m), "set_batch_group"):
                m.set_batch_group(group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        fn = getattr(self._layers, "set_state_dict",
                     self._layers.load_state_dict)
        return fn(state_dict, *a, **k)


class GroupShardedStage2(_ShardedLayerWrapper):
    """The layer of a ZeRO-2 run; its stage-2 optimizer(s) average the
    gradients at the step."""

    def __init__(self, layer: nn.Module, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device="gpu", dp_group=None):
        super().__init__(layer, group)
        self._sharding_optimizers = (
            sharding_optimizer if isinstance(sharding_optimizer, list)
            else [sharding_optimizer])


class _Freed:
    """A saved tensor whose storage was a gathered ZeRO-3 parameter: the
    shard and the view to take of it when gathered again."""

    __slots__ = ("param", "size", "stride", "offset")

    def __init__(self, param, t):
        self.param, self.size = param, t.size()
        self.stride, self.offset = t.stride(), t.storage_offset()


def _zero3(p):
    return p is not None and "_zero3" in p.__dict__


_GATHERING = {}


def _gathering(cls):
    """``cls`` with a ``__getattr__`` that reads a ZeRO-3 parameter as its
    gathered whole while its ``GroupShardedStage3`` is in a forward."""
    sub = _GATHERING.get(cls)
    if sub is None:
        def __getattr__(self, name):
            params = self.__dict__.get("_parameters")
            if params is not None and name in params:
                p = params[name]
                stage = self.__dict__.get("_zero3_stage")
                if _zero3(p) and stage is not None and stage._depth:
                    return stage._whole(p)
                return p
            return cls.__getattr__(self, name)

        sub = _GATHERING[cls] = type(cls.__name__, (cls,),
                                     {"__getattr__": __getattr__,
                                      "__module__": cls.__module__})
    return sub


class GroupShardedStage3(_ShardedLayerWrapper):
    """ZeRO-3 (module docstring): shards ``optimizer`` at stage 3 over
    ``group``'s mesh axis (else the resolved one) unless it already is,
    then gathers the sharded parameters for use. ``segment_size``,
    ``offload``, ``sync_comm`` and the rest are accepted and ignored, as
    in the reference."""

    def __init__(self, layer: nn.Module, optimizer, group=None,
                 sync_buffers=False, device="gpu", segment_size=2 ** 20,
                 pertrain_sync_models=True, offload=False, sync_comm=False,
                 dp_group=None, exclude_layer=None):
        rows = getattr(optimizer, "_row_shards", None)
        if rows is None or rows.stage != 3:
            from ....sharding import _resolve_mesh_axis

            mesh, axis = _resolve_mesh_axis(layer, group)
            shard_optimizer(optimizer, ShardingStage3(axis, mesh=mesh))
        super().__init__(layer, group)
        self._optimizer = optimizer
        self._depth = 0
        self._gathered = {}             # id(param) -> its whole tensor
        self._live = {}                 # storage pointer -> param
        for m in layer.modules():
            if any(_zero3(p) for p in m._parameters.values()):
                m.__class__ = _gathering(type(m))
                m.__dict__["_zero3_stage"] = self
                m.register_forward_pre_hook(self._enter)
                m.register_forward_hook(self._leave)

    @property
    def optimizer(self):
        return self._optimizer

    def _whole(self, p):
        whole = self._gathered.get(id(p))
        if whole is None:
            whole = self._gathered[id(p)] = gather_rows(p)
            self._live[whole.untyped_storage().data_ptr()] = p
        return whole

    def _drop(self, p):
        whole = self._gathered.pop(id(p), None)
        if whole is not None:
            self._live.pop(whole.untyped_storage().data_ptr(), None)

    def _enter(self, module, args):
        self._depth += 1

    def _leave(self, module, args, out):
        self._depth -= 1
        for p in module._parameters.values():
            if _zero3(p):
                self._drop(p)

    def _pack(self, t):
        if self._live and t.layout == torch.strided:
            p = self._live.get(t.untyped_storage().data_ptr())
            if p is not None:
                return _Freed(p, t)
        return t

    @staticmethod
    def _unpack(obj):
        if isinstance(obj, _Freed):
            whole = gather_rows(obj.param, differentiable=False)
            return whole.as_strided(obj.size, obj.stride, obj.offset)
        return obj

    def forward(self, *inputs, **kwargs):
        self._depth += 1
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                return self._layers(*inputs, **kwargs)
        finally:
            self._depth -= 1
            for pid in list(self._gathered):
                whole = self._gathered.pop(pid)
                self._live.pop(whole.untyped_storage().data_ptr(), None)
