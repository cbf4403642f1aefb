"""paddle.distributed of the port: process groups, collectives, the
rendezvous store, the launcher and ``DataParallel``, over
``torch.distributed`` (NCCL on the card, gloo on the CPU), and
``fleet.utils.recompute``.

Counterpart of ``paddle_tpu/distributed/__init__.py``, one process a
rank (the reference drives a device mesh from one process a host). Run
``python -m paddle_tpu_torch.distributed.launch --nnodes N --node_rank R
--master host:port train.py`` on each node, or set the launcher's
variables yourself; ``init_parallel_env()`` brings the group up.

Placements, meshes and the semi-auto API (``auto_parallel``), the
hybrid topology, tensor and sequence parallelism (``fleet``) and the
model-parallel ``split`` are ROADMAP queue A item 4 (b); expert
parallelism (``incubate.distributed.models.moe``'s ``moe_group``) is
(b2); ZeRO sharding (``sharding``: ``group_sharded_parallel``,
``save_group_sharded_model``; ``shard_optimizer``'s stages 1 to 3;
``fleet.meta_parallel`` and ``fleet.meta_optimizers``) is (c). The
reference's names that are not here belong to later parts of item 4:
checkpointing, elastic training, the parameter server, RPC and the
fleet executor (f); ``passes`` rewrite static programs (item 7).
"""
from __future__ import annotations

from . import auto_parallel, communication, env, fleet  # noqa: F401
from . import launch_utils, parallel_wrapper, sharding, store  # noqa: F401
from . import utils  # noqa: F401
from .auto_parallel import (  # noqa: F401
    DistModel, Partial, Placement, ProcessMesh, Replicate, Shard,
    ShardDataloader, ShardingStage1, ShardingStage2, ShardingStage3,
    Strategy, dtensor_from_fn, reshard, shard_dataloader, shard_layer,
    shard_optimizer, shard_tensor, to_static, unshard_dtensor)
from .communication import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    all_to_all_single, batch_isend_irecv, broadcast, broadcast_object_list,
    destroy_process_group, gather, get_group, irecv, isend, new_group, recv,
    reduce, reduce_scatter, scatter, send, wait)
from .communication import all_to_all as alltoall  # noqa: F401
from .communication import all_to_all_single as alltoall_single  # noqa: F401
from .env import (barrier, get_backend, get_rank, get_store,  # noqa: F401
                  get_world_size, init_parallel_env, is_initialized)
from .launch_utils import launch, spawn  # noqa: F401
from .parallel_wrapper import DataParallel  # noqa: F401
from .sharding import (group_sharded_parallel,  # noqa: F401
                       save_group_sharded_model)
from .store import InMemoryStore, Store, TCPStore, create_store  # noqa: F401

# paddle.distributed.parallel compat namespace
parallel = env

__all__ = [
    "CountFilterEntry", "DataParallel", "DistAttr", "DistModel",
    "InMemoryStore", "P2POp", "ParallelEnv", "ParallelMode", "Partial",
    "Placement", "ProbabilityEntry", "ProcessMesh", "ReduceOp",
    "ReduceType", "Replicate", "Shard", "ShardDataloader",
    "ShardingStage1", "ShardingStage2", "ShardingStage3",
    "ShowClickEntry", "Store", "Strategy", "TCPStore", "all_gather",
    "all_gather_object", "all_reduce", "all_to_all", "all_to_all_single",
    "alltoall", "alltoall_single", "barrier", "batch_isend_irecv",
    "broadcast", "broadcast_object_list", "communication", "create_store",
    "destroy_process_group", "env", "fleet", "gather", "get_backend",
    "get_device_count", "get_group", "get_rank", "get_store",
    "get_world_size", "gloo_barrier", "gloo_init_parallel_env",
    "gloo_release", "init_parallel_env", "irecv", "is_available",
    "is_initialized", "isend", "launch", "launch_utils", "new_group",
    "parallel", "parallel_wrapper", "recv", "reduce", "reduce_scatter",
    "scatter", "scatter_object_list", "send", "shard_scaler", "spawn",
    "split", "store", "utils", "wait", "auto_parallel", "dtensor_from_fn",
    "sharding", "group_sharded_parallel", "save_group_sharded_model",
    "reshard", "shard_dataloader", "shard_layer", "shard_optimizer",
    "shard_tensor", "to_static", "unshard_dtensor",
]


def get_device_count():
    """Cards visible to this process."""
    return env.device_count()


def is_available() -> bool:
    """Whether ``torch.distributed`` is built in."""
    import torch.distributed as dist

    return dist.is_available()


class ParallelEnv:
    """The rank topology read from the environment (Paddle's
    ``distributed/parallel.py`` ``ParallelEnv``)."""

    def __init__(self):
        self._rank = env.get_rank()
        self._world_size = env.get_world_size()

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def local_rank(self):
        import os

        return int(os.environ.get("PADDLE_LOCAL_RANK", self._rank))

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def nranks(self):
        return self._world_size


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Rank ``r`` of the group takes the ``r``-th equal share of
    ``in_object_list``. As in the reference the whole list is passed on
    every rank (``src`` is checked, not read): ``None`` raises."""
    rank = env.get_rank(group)
    world = env.get_world_size(group)
    if in_object_list is None:
        if rank == src:
            raise ValueError("src rank must provide in_object_list")
        raise NotImplementedError(
            "scatter_object_list with rank-local None: pass the full list "
            "on every rank, as the reference requires")
    if len(in_object_list) % world:
        raise ValueError(
            f"in_object_list length {len(in_object_list)} must divide the "
            f"group size {world}")
    per = len(in_object_list) // world
    out_object_list.clear()
    out_object_list.extend(in_object_list[rank * per:(rank + 1) * per])


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """Paddle's ``parallel_with_gloo.py`` bootstrap: validates its
    arguments before touching the environment, then sets the variables
    ``init_parallel_env`` reads (where they are not set)."""
    import os

    rank_id = int(rank_id)
    rank_num = int(rank_num)
    if not isinstance(server_endpoint, str):
        raise TypeError("gloo_init_parallel_env: server_endpoint must be "
                        f"an 'ip:port' string, got {type(server_endpoint)}")
    if rank_id < 0 or rank_num <= 0 or rank_id >= rank_num:
        raise ValueError(
            f"gloo_init_parallel_env: need 0 <= rank_id < rank_num, got "
            f"rank_id={rank_id} rank_num={rank_num}")
    os.environ.setdefault("PADDLE_TRAINER_ID", str(rank_id))
    os.environ.setdefault("PADDLE_TRAINERS_NUM", str(rank_num))
    os.environ.setdefault("PADDLE_MASTER", server_endpoint)


def gloo_barrier():
    communication.barrier()


def gloo_release():
    """Nothing to release: the group lives until
    ``destroy_process_group``."""


_split_layers: dict = {}


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Model-parallel ``split`` (Paddle's ``mp_ops.py`` ``split``): a
    vocab-parallel embedding (``operation="embedding"``) or a row
    (``axis=0``) / column (``axis=1``) parallel linear of ``size`` over
    the hybrid group's mp axis, applied to ``x``. The layer is made once
    per (``name``, configuration), so calls reuse its parameters, as the
    reference's cache does; pass ``name`` to tell apart two splits of one
    configuration. ``num_partitions`` must be the mp degree."""
    from .fleet.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                  VocabParallelEmbedding, _degree,
                                  _mp_group)

    degree = _degree(_mp_group())
    if int(num_partitions) not in (1, degree):
        raise ValueError(f"split: num_partitions={num_partitions} but the "
                         f"mp degree is {degree}")
    key = (name, operation, tuple(size), axis, num_partitions, gather_out)
    layer = _split_layers.get(key)
    if layer is None:
        kw = dict(device=x.device)
        if operation == "embedding":
            layer = VocabParallelEmbedding(size[0], size[1],
                                           weight_attr=weight_attr, **kw)
        elif operation == "linear":
            has_bias = bias_attr is not False
            if axis == 0:
                layer = RowParallelLinear(size[0], size[1],
                                          weight_attr=weight_attr,
                                          has_bias=has_bias, **kw)
            else:
                layer = ColumnParallelLinear(size[0], size[1],
                                             weight_attr=weight_attr,
                                             has_bias=has_bias,
                                             gather_output=gather_out, **kw)
        else:
            raise ValueError(f"unsupported operation {operation!r}")
        _split_layers[key] = layer
    return layer(x)


class DistAttr:
    """A tensor's mesh and sharding specs (Paddle's ``DistAttr``): one
    mesh dim name or None per tensor dim; ``dims_mapping`` gives each
    tensor dim's mesh dim (-1 replicated) and ``placements`` the same as
    placements (one per mesh dim)."""

    def __init__(self, mesh, sharding_specs):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs)

    @property
    def dims_mapping(self):
        names = list(getattr(self.process_mesh, "dim_names", []))
        return [(names.index(s) if s in names else -1)
                for s in self.sharding_specs]

    @property
    def placements(self):
        from .auto_parallel.placement import spec_to_placements

        return spec_to_placements(self.sharding_specs, self.process_mesh,
                                  len(self.sharding_specs))


def shard_scaler(scaler):
    """A ``GradScaler`` for sharded gradients. The port's scaler already
    works on them: each rank's gradients are its shards, and its
    ``found_inf`` is made the same on every rank by an all-reduce (MAX)
    over the world when a process group is up, so every rank skips the
    same steps. Returns the scaler."""
    scaler._sync_found_inf = True
    return scaler


# PS-mode sparse-table entry configs (Paddle's distributed/entry_attr.py)
class ProbabilityEntry:
    def __init__(self, probability):
        self._name = "probability_entry"
        self._probability = probability

    def _to_attr(self):
        return f"{self._name}:{self._probability}"


class CountFilterEntry:
    def __init__(self, count_filter):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self._name = "count_filter_entry"
        self._count_filter = count_filter

    def _to_attr(self):
        return f"{self._name}:{self._count_filter}"


class ShowClickEntry:
    def __init__(self, show_name, click_name):
        self._name = "show_click_entry"
        self._show_name = show_name
        self._click_name = click_name

    def _to_attr(self):
        return f"{self._name}:{self._show_name}:{self._click_name}"


class ParallelMode:
    """Paddle's ``distributed/parallel.py`` ``ParallelMode``."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class ReduceType:
    """The placement reduce types (phi ``ReduceType``)."""

    kRedSum = 0
    kRedMax = 1
    kRedMin = 2
    kRedProd = 3
    kRedAvg = 4
    kRedAny = 5
    kRedAll = 6
