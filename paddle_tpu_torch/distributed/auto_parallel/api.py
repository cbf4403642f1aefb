"""The semi-auto parallel API: ``shard_tensor``, ``dtensor_from_fn``,
``reshard``, ``unshard_dtensor``, ``shard_layer``, ``shard_optimizer``
and ``shard_dataloader``, over ``torch.distributed.tensor``.

Counterpart of ``paddle_tpu/distributed/auto_parallel/api.py``. The
reference lays a jax array out over its mesh and lets GSPMD partition
the program; here a tensor becomes a ``DTensor`` and torch's sharding
propagation does the same per op, one process a rank.

Parameters. ``shard_tensor`` on an ``nn.Parameter`` shards it in place,
as the reference's does (its ``api.py:52-55``), so a module and an
optimizer built before the call see the sharded parameter.
``torch.utils.swap_tensors`` cannot turn a ``Parameter`` into a
``DTensor``: their ``__slots__`` differ, and it refuses. So the
parameter object stays, its data becomes this rank's shard and its class
:class:`DistParameter`, which carries the mesh and the placements:
``as_dtensor()`` is the ``DTensor`` over that shard (autograd flows
through it to the shard), ``full_tensor()`` the whole tensor, and
``p.grad`` is the shard's gradient. Code that runs on local tensors (the
fleet layers, the models' shard plans, the optimizers, every kernel)
reads the parameter as it is. ``shard_layer`` makes the modules it
shards read their parameters as ``DTensor``\\ s during their forward, so
a layer fed ``DTensor``\\ s computes under torch's propagation, as the
reference's does under GSPMD.

Other tensors become ``DTensor``\\ s; ``reshard`` redistributes them (every
pairwise r<->s, s->s', p->r conversion), differentiably.
``shard_optimizer`` lays each state out like its parameter (the states
of a :class:`DistParameter` are its shard's) and shards them over the
data-parallel axis (ZeRO). A parameter whose dim 0 the axis divides is
updated in this rank's rows only, with states of those rows:

- stage 1: the gradients arrive averaged (``DataParallel``, or a layer
  computing on ``DTensor``\\ s); each rank updates its rows and the rows
  are all-gathered after the step (``restore_param_layouts``);
- stage 2: each rank's gradient rows come from a reduce-scatter of the
  ranks' whole gradients at the step, the other gradients from an
  all-reduce (each divided by the ranks: the mean), then as stage 1;
- stage 3: those parameters are sharded between steps too
  (``Shard(0)`` on the axis); see :class:`ShardingStage3` for what
  gathers them, and when.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from .placement import (Placement, ProcessMesh, Replicate, Shard,
                        to_torch_placements)

__all__ = [
    "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
    "shard_optimizer", "ShardingStage0", "ShardingStage1", "ShardingStage2",
    "ShardingStage3", "unshard_dtensor", "shard_dataloader",
    "ShardDataloader", "DistParameter", "restore_param_layouts",
    "gather_rows",
]


def _is_strided(p) -> bool:
    return type(p).__name__ == "_StridedShard"


def _split_factor(p) -> int:
    return int(p.split_factor)


def _local_shard(t: torch.Tensor, dm, tpl):
    """This rank's shard of the whole tensor ``t`` under torch placements
    ``tpl`` (rank 0's ``t`` where ranks differ, as ``distribute_tensor``
    scatters it). ``Partial`` leaves ``t`` on the first rank of its mesh
    dimension and zeros on the others; a ``_StridedShard(d, sf)`` views
    dimension ``d`` as ``sf`` equal parts and keeps this rank's chunk of
    each."""
    from torch.distributed import tensor as tdt

    plain = [tdt.Replicate() if isinstance(p, tdt.Partial) or _is_strided(p)
             else p for p in tpl]
    local = tdt.distribute_tensor(t, dm, plain).to_local()
    coord = dm.get_coordinate()
    for m, p in enumerate(tpl):
        if isinstance(p, tdt.Partial) and coord[m] != 0:
            local = torch.zeros_like(local)
        elif _is_strided(p):
            n, d, sf = dm.size(m), p.dim, _split_factor(p)
            if local.shape[d] % (sf * n):
                raise ValueError(
                    f"_StridedShard({d}, split_factor={sf}) over {n} "
                    f"rank(s) needs dim {d} ({local.shape[d]}) divisible "
                    f"by {sf * n}")
            shape = list(local.shape)
            parts = local.reshape(shape[:d] + [sf, n, shape[d] // (sf * n)]
                                  + shape[d + 1:])
            local = parts.select(d + 1, coord[m]).reshape(
                shape[:d] + [shape[d] // n] + shape[d + 1:]).contiguous()
    return local.contiguous()


class DistParameter(torch.nn.Parameter):
    """A parameter sharded in place (module docstring): its data is this
    rank's shard of a tensor of ``global_shape`` laid out over
    ``process_mesh`` by ``placements``."""

    @property
    def process_mesh(self) -> ProcessMesh:
        return self.__dict__["_dist_mesh"]

    @property
    def device_mesh(self):
        return self.process_mesh.device_mesh

    @property
    def placements(self) -> List[Placement]:
        return list(self.__dict__["_dist_placements"])

    @property
    def torch_placements(self):
        return list(self.__dict__["_dist_tpl"])

    @property
    def global_shape(self):
        return torch.Size(self.__dict__["_dist_shape"])

    def to_local(self):
        return self

    def _view(self, local):
        from torch.distributed.tensor import DTensor

        shape = self.global_shape
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.device_mesh,
                                  self.torch_placements, run_check=False,
                                  shape=shape, stride=stride)

    def as_dtensor(self):
        """The ``DTensor`` over this shard; gradients reach the shard."""
        return self._view(self)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``local`` (the parameter's, its
        gradient's or a state's) is this rank's shard, on every rank."""
        tpl = self.torch_placements
        local = local.detach()
        if not any(_is_strided(p) for p in tpl):
            return self._view(local).full_tensor()
        from torch.distributed import tensor as tdt

        dm = self.device_mesh
        for m in reversed(range(len(tpl))):
            p, n = tpl[m], dm.size(m)
            if isinstance(p, tdt.Replicate) or n == 1:
                continue
            if not _is_strided(p):
                raise NotImplementedError(
                    "gather: a _StridedShard mixed with other shards or "
                    "partials")
            parts = [torch.empty_like(local) for _ in range(n)]
            torch.distributed.all_gather(parts, local.contiguous(),
                                         group=dm.get_group(m))
            d, sf = p.dim, _split_factor(p)
            shape = list(local.shape)
            chunks = [q.reshape(shape[:d] + [sf, shape[d] // sf]
                                + shape[d + 1:]) for q in parts]
            local = torch.stack(chunks, dim=d + 1).reshape(
                shape[:d] + [shape[d] * n] + shape[d + 1:])
        return local

    def full_tensor(self) -> torch.Tensor:
        return self.gather(self)

    def __repr__(self):
        return (f"DistParameter(global_shape={list(self.global_shape)}, "
                f"local_shape={list(self.shape)}, "
                f"placements={self.placements}, mesh={self.process_mesh})")


def _shard_param_(p: torch.nn.Parameter, mesh: ProcessMesh, placements,
                  torch_placements=None):
    """Shard ``p`` in place (module docstring); ``torch_placements``
    overrides the torch placements of ``placements`` (a plan's
    ``_StridedShard``)."""
    if isinstance(p, DistParameter):
        whole = p.full_tensor()
    else:
        whole = p.detach()
    tpl = list(torch_placements) if torch_placements is not None else \
        to_torch_placements(placements)
    with torch.no_grad():
        local = _local_shard(whole, mesh.device_mesh, tpl)
    shape = tuple(whole.shape)
    p.data = local
    p.__class__ = DistParameter
    p.__dict__.update(_dist_mesh=mesh, _dist_placements=list(placements),
                      _dist_tpl=tpl, _dist_shape=shape)
    return p


def shard_tensor(data, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, place=None, stop_gradient=None):
    """Lay ``data`` out over ``mesh``: a ``Parameter`` in place (a
    :class:`DistParameter`, the same object), anything else as a new
    ``DTensor`` (module docstring). The whole tensor is taken from the
    mesh's first rank."""
    from torch.distributed import tensor as tdt

    if isinstance(data, torch.nn.Parameter):
        out = _shard_param_(data, mesh, placements)
    else:
        if isinstance(data, tdt.DTensor):
            return reshard(data, mesh, placements)
        t = data if isinstance(data, torch.Tensor) else torch.as_tensor(
            data, dtype=dtype)
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        if place is not None:
            t = t.to(place)
        tpl = to_torch_placements(placements)
        dm = mesh.device_mesh
        local = _local_shard(t.detach(), dm, tpl)
        out = tdt.DTensor.from_local(local, dm, tpl, run_check=False,
                                     shape=t.shape, stride=t.stride())
        out.requires_grad_(t.requires_grad)
    if stop_gradient is not None:
        out.requires_grad_(not stop_gradient)
    return out


def dtensor_from_fn(fn: Callable, mesh: ProcessMesh,
                    placements: Sequence[Placement], *args, **kwargs):
    """Build the tensor with ``fn`` and shard it."""
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(x, mesh: ProcessMesh, placements: Sequence[Placement]):
    """``x`` laid out by ``placements`` over ``mesh``, differentiably: a
    ``DTensor`` is redistributed (``all_gather`` for s->r,
    ``reduce_scatter`` for p->s, ``all_reduce`` for p->r, an all-to-all
    for s->s', a local slice for r->s); a :class:`DistParameter` goes
    through its ``DTensor``; a local tensor is taken as replicated. A
    ``DTensor`` on another mesh is gathered whole first."""
    from torch.distributed import tensor as tdt

    dm = mesh.device_mesh
    tpl = to_torch_placements(placements)
    if isinstance(x, DistParameter):
        x = x.as_dtensor()
    elif not isinstance(x, tdt.DTensor):
        x = tdt.DTensor.from_local(x, dm, [tdt.Replicate()] * dm.ndim,
                                   run_check=False)
    if x.device_mesh != dm:
        x = tdt.DTensor.from_local(x.full_tensor(), dm,
                                   [tdt.Replicate()] * dm.ndim,
                                   run_check=False)
    return x.redistribute(dm, tpl)


def unshard_dtensor(x):
    """The whole tensor of a ``DTensor`` or :class:`DistParameter`
    (differentiable for a ``DTensor``); a local tensor as it is."""
    from torch.distributed import tensor as tdt

    if isinstance(x, (DistParameter, tdt.DTensor)):
        return x.full_tensor()
    return x


# ---------------------------------------------------------------- layers
def _dtensor_params_pre(module, args):
    for name, p in module._parameters.items():
        if isinstance(p, DistParameter):
            d = p.as_dtensor()
            axis = p.__dict__.get("_zero3_axis")
            if axis is not None:            # ZeRO-3: gathered for use
                from torch.distributed import tensor as tdt

                tpl = list(d.placements)
                tpl[axis] = tdt.Replicate()
                d = d.redistribute(d.device_mesh, tpl)
            object.__setattr__(module, name, d)


def _dtensor_params_post(module, args, out):
    for name, p in module._parameters.items():
        if isinstance(p, DistParameter):
            module.__dict__.pop(name, None)


def _replicated_inputs(mesh):
    def hook(module, args):
        from torch.distributed import tensor as tdt

        dm = mesh.device_mesh
        rep = [tdt.Replicate()] * dm.ndim
        return tuple(
            tdt.DTensor.from_local(a, dm, rep, run_check=False)
            if isinstance(a, torch.Tensor)
            and not isinstance(a, tdt.DTensor) else a for a in args)
    return hook


def compute_on_dtensors(layer, mesh: ProcessMesh):
    """Make ``layer`` compute on ``DTensor``\\ s over ``mesh`` (once): each
    module reads its :class:`DistParameter`\\ s as ``DTensor``\\ s during
    its forward, and local tensor inputs of the layer enter
    replicated."""
    if getattr(layer, "_computes_on_dtensors", False):
        return layer
    for sub in layer.modules():
        if any(isinstance(p, DistParameter)
               for p in sub._parameters.values()):
            sub.register_forward_pre_hook(_dtensor_params_pre)
            sub.register_forward_hook(_dtensor_params_post)
    layer.register_forward_pre_hook(_replicated_inputs(mesh))
    layer._computes_on_dtensors = True
    return layer


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn: Callable = None,
                input_fn: Callable = None, output_fn: Callable = None):
    """Apply ``shard_fn(name, sublayer, mesh)`` to every sublayer
    (default: replicate each parameter not yet sharded) and make the
    layer compute on ``DTensor``\\ s: each module reads its sharded
    parameters as ``DTensor``\\ s during its forward, and local tensor
    inputs of the layer enter replicated (``input_fn(inputs, mesh)``
    replaces that; ``output_fn(outputs, mesh)`` maps the outputs)."""

    def default_shard_fn(name, sublayer, mesh):
        for p in list(sublayer._parameters.values()):
            if p is not None and not isinstance(p, DistParameter):
                shard_tensor(p, mesh, [Replicate()] * mesh.ndim)

    fn = shard_fn or default_shard_fn
    for name, sub in layer.named_modules():
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inputs: input_fn(inputs, process_mesh))
    compute_on_dtensors(layer, process_mesh)
    if output_fn is not None:
        layer.register_forward_hook(
            lambda l, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


# ------------------------------------------------------------- optimizer
class ShardingStage0:
    """No optimizer-state sharding (each state laid out like its
    parameter)."""

    def __init__(self, mesh_dim=None, mesh=None):
        self.mesh_dim = mesh_dim
        self.mesh = mesh


class ShardingStage1(ShardingStage0):
    """ZeRO-1: the states sharded by rows over the data-parallel axis."""

    def __init__(self, mesh_dim="dp", mesh=None):
        super().__init__(mesh_dim, mesh)


class ShardingStage2(ShardingStage1):
    """ZeRO-2: the states sharded as at stage 1, and each rank's gradient
    rows the mean over the axis by a reduce-scatter at the step (module
    docstring). The stage averages the gradients itself, so the model
    needs no ``DataParallel``; with one, the mean of equal gradients
    changes nothing."""


class ShardingStage3(ShardingStage1):
    """ZeRO-3: every parameter whose dim 0 the axis divides is sharded
    between steps (a :class:`DistParameter`, ``Shard(0)`` on the axis:
    this rank's rows and their states); the others stay replicated and
    their gradients are averaged over the axis at the step. Nothing is
    gathered after the update. What gathers a sharded parameter, and
    when:

    - a layer that computes on ``DTensor``\\ s (``shard_layer``,
      ``DistModel``) all-gathers it to replicated on the axis
      (``reshard``) in the forward pre-hook of the module that owns it;
      the gathered tensor is what that module's backward uses, and the
      backward's reduce-scatter gives the shard its gradient;
    - ``group_sharded_parallel(level="p_g_os")`` wraps the model in
      ``GroupShardedStage3``, which gathers it (``gather_rows``: an
      all-gather whose backward reduce-scatters the gradient and divides
      it by the ranks) when a module reads it during the model's
      forward, drops the whole tensor when the owning module's forward
      returns, keeps none for the backward (a saved-tensor hook stores a
      reference to the shard in its place) and all-gathers it again
      where the backward unpacks it
      (``fleet/meta_parallel/sharding``).

    A layer that computes on local tensors and goes through neither
    would read the shard itself: use one of the two."""


class _RowShards:
    """ZeRO state sharding over one axis (module docstring, stage 1 to
    3): each row-sharded parameter's rows of this rank (``view``, a view
    of the parameter's local data) and the states made for the view, an
    ``all_gather`` of the rows after the update; at stage 3 the
    parameters sharded between steps (``sharded``)."""

    def __init__(self, optimizer, group, rank, nranks, stage=1):
        self.group, self.rank, self.nranks = group, rank, nranks
        self.stage = stage
        self.views = {}
        self.sharded = set()
        for p in optimizer._parameter_list:
            if not (p.ndim > 0 and p.shape[0] % nranks == 0 and p.shape[0]):
                continue
            if stage == 3:
                self.sharded.add(id(p))
                continue
            rows = p.shape[0] // nranks
            view = p.data.narrow(0, rank * rows, rows)
            for attr in ("optimize_attr", "regularizer"):
                if hasattr(p, attr):
                    setattr(view, attr, getattr(p, attr))
            view._zero_groups = _norm_groups(p) + (group,)
            self.views[id(p)] = (p, view)

    def slice(self, pairs):
        out = []
        for p, g in pairs:
            entry = self.views.get(id(p))
            if entry is None:
                out.append((p, g))
                continue
            rows = entry[1].shape[0]
            out.append((entry[1], g.narrow(0, self.rank * rows, rows)))
        return out

    def reduce(self, pairs):
        """Stages 2 and 3, before the clip: each gradient's mean over the
        axis, paired with what the update writes: this rank's rows of a
        row-sharded parameter (a reduce-scatter), a stage-3 shard's
        gradient as it is (its backward reduce-scattered it), every
        other gradient whole (an all-reduce)."""
        out = []
        for p, g in pairs:
            if g is None or id(p) in self.sharded:
                out.append((p, g))
                continue
            entry = self.views.get(id(p))
            g = g.contiguous()
            if entry is None:
                mean = g.clone()
                torch.distributed.all_reduce(mean, group=self.group)
            else:
                p = entry[1]
                mean = g.new_empty(p.shape)
                torch.distributed.reduce_scatter_tensor(mean, g,
                                                        group=self.group)
            out.append((p, mean.div_(self.nranks)))
        return out

    def gather(self):
        for p, view in self.views.values():
            torch.distributed.all_gather_into_tensor(
                p.data, view.clone(), group=self.group)


def _norm_groups(p):
    """The process groups over which ``p``'s gradient is a part of the
    whole (a :class:`DistParameter`'s sharded mesh dimensions of more
    than one rank, and a row view's ZeRO axis): a global norm sums its
    squares over them."""
    groups = tuple(getattr(p, "_zero_groups", ()))
    if isinstance(p, DistParameter):
        dm = p.device_mesh
        groups += tuple(dm.get_group(m) for m, pl in enumerate(p.placements)
                        if not pl.is_replicated() and dm.size(m) > 1)
    return groups


def restore_param_layouts(optimizer) -> None:
    """Give every parameter its recorded layout after an update: the rows
    that each rank updated at ZeRO stage 1 or 2 all-gathered into the
    whole parameter (the reference re-constrains each parameter to its
    placement, which XLA lowers to the same all-gather). Stage 3's
    shards stay sharded; without ``shard_optimizer`` nothing moves."""
    rows = getattr(optimizer, "_row_shards", None)
    if rows is not None:
        rows.gather()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, pg, n):
        ctx.pg, ctx.n = pg, n
        whole = shard.new_empty((n * shard.shape[0],) + shard.shape[1:])
        torch.distributed.all_gather_into_tensor(whole, shard.contiguous(),
                                                 group=pg)
        return whole

    @staticmethod
    def backward(ctx, g):
        part = g.new_empty((g.shape[0] // ctx.n,) + g.shape[1:])
        torch.distributed.reduce_scatter_tensor(part, g.contiguous(),
                                                group=ctx.pg)
        return part.div_(ctx.n), None, None


def gather_rows(p, differentiable=True):
    """The whole tensor of a ZeRO-3 parameter ``p`` (sharded ``Shard(0)``
    on its ZeRO axis), all-gathered from the axis; differentiable: the
    backward reduce-scatters the gradient and divides it by the ranks
    (the mean over the data-parallel ranks)."""
    pg, n = p.__dict__["_zero3"]
    if not differentiable:
        whole = p.new_empty((n * p.shape[0],) + p.shape[1:])
        torch.distributed.all_gather_into_tensor(whole, p.detach(),
                                                 group=pg)
        return whole
    return _GatherRows.apply(p, pg, n)


def _shard_rows_(p, mesh: ProcessMesh, axis: int):
    """Stage 3: shard ``p`` in place ``Shard(0)`` on mesh dimension
    ``axis``, on top of its placements on the other dimensions."""
    placements = list(p.placements) if isinstance(p, DistParameter) else \
        [Replicate()] * mesh.ndim
    placements[axis] = Shard(0)
    _shard_param_(p, mesh, placements)
    dm = mesh.device_mesh
    p.__dict__["_zero3"] = (dm.get_group(axis), dm.size(axis))
    p.__dict__["_zero3_axis"] = axis
    return p


def shard_optimizer(optimizer, shard_fn=None):
    """Lay each optimizer state out like its parameter and, at stages 1
    to 3, shard them over ``shard_fn.mesh_dim`` of the parameters' mesh
    (``shard_fn.mesh`` where given); stage 3 also shards the parameters
    (module docstring). The states are made now."""
    stage = shard_fn if shard_fn is not None else ShardingStage0()
    if isinstance(stage, ShardingStage1):
        mesh = stage.mesh
        if mesh is None:
            meshes = [p.process_mesh for p in optimizer._parameter_list
                      if isinstance(p, DistParameter)]
            if not meshes:
                raise ValueError(
                    "shard_optimizer: no parameter is sharded; pass the "
                    "mesh (ShardingStage1(mesh_dim, mesh=...))")
            mesh = meshes[0]
        if stage.mesh_dim not in mesh.dim_names:
            raise ValueError(f"shard_optimizer: {stage.mesh_dim!r} is not "
                             f"a dimension of {mesh}")
        dm = mesh.device_mesh
        axis = mesh.dim_names.index(stage.mesh_dim)
        nranks = dm.size(axis)
        if nranks > 1:
            level = 3 if isinstance(stage, ShardingStage3) else \
                2 if isinstance(stage, ShardingStage2) else 1
            rows = _RowShards(optimizer, dm.get_group(axis),
                              dm.get_local_rank(axis), nranks, level)
            for p in optimizer._parameter_list:
                if id(p) in rows.sharded:
                    _shard_rows_(p, mesh, axis)
            optimizer._row_shards = rows
    optimizer._ensure_accumulators()
    return optimizer


# ------------------------------------------------------------ dataloader
class ShardDataloader:
    """A loader whose every tensor is laid out on the mesh, the batch
    dimension sharded over ``shard_dims`` (default: the mesh's first
    axis); ``shard_dims`` may be a list (by position) or a dict (by key)
    as the reference's is."""

    def __init__(self, dataloader, meshes, input_keys=None, shard_dims=None,
                 is_dataset_splitted: bool = False):
        self._loader = dataloader
        self._meshes = meshes if isinstance(meshes, (list, tuple)) \
            else [meshes]
        self._input_keys = input_keys
        if shard_dims is None:
            shard_dims = self._meshes[0].dim_names[0]
        self._shard_dims = shard_dims
        self._is_dataset_splitted = is_dataset_splitted

    def __len__(self):
        return len(self._loader)

    def _placements(self, mesh: ProcessMesh, shard_dim):
        placements: List[Placement] = [Replicate()] * mesh.ndim
        if shard_dim is not None:
            idx = shard_dim if isinstance(shard_dim, int) \
                else mesh.dim_names.index(shard_dim)
            placements[idx] = Shard(0)
        return placements

    def _shard_item(self, item, mesh, shard_dim):
        if isinstance(item, torch.Tensor):
            if isinstance(shard_dim, (list, tuple, dict)):
                shard_dim = None
            return shard_tensor(item, mesh, self._placements(mesh, shard_dim))
        if isinstance(item, dict):
            if isinstance(shard_dim, dict):
                return {k: self._shard_item(v, mesh, shard_dim.get(k))
                        for k, v in item.items()}
            return {k: self._shard_item(v, mesh, shard_dim)
                    for k, v in item.items()}
        if isinstance(item, (list, tuple)):
            if isinstance(shard_dim, (list, tuple)):
                return type(item)(self._shard_item(v, mesh, d)
                                  for v, d in zip(item, shard_dim))
            return type(item)(self._shard_item(v, mesh, shard_dim)
                              for v in item)
        return item

    def __iter__(self):
        mesh = self._meshes[0]
        for batch in self._loader:
            yield self._shard_item(batch, mesh, self._shard_dims)


def shard_dataloader(dataloader, meshes, input_keys=None, shard_dims=None,
                     is_dataset_splitted: bool = False) -> ShardDataloader:
    return ShardDataloader(dataloader, meshes, input_keys, shard_dims,
                           is_dataset_splitted)
