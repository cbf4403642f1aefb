"""``paddle.distributed.fleet`` of the port, its collective part:
``DistributedStrategy``, ``init(is_collective=True)``, the hybrid
topology, ``distributed_model`` / ``distributed_optimizer``, the
tensor-parallel layers and sequence parallelism, and ``utils``
(``recompute``).

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``.
``init`` brings the process group up (``init_parallel_env``) and builds
the ``HybridCommunicateGroup`` of ``strategy.hybrid_configs``; a
``dp_degree`` left at 1 takes the ranks the other degrees leave, as
Paddle's does. ``distributed_model`` wraps a ``PipelineLayer`` in
``PipelineParallel`` at a ``pp_degree`` above 1 and a model in
``SegmentParallel`` (context parallelism: the sequence cut over the sep
ranks, the gradients summed over them) at a ``sep_degree`` above 1.
``distributed_optimizer`` at a ``sharding_degree`` above 1 returns the
``HybridParallelOptimizer`` (``meta_optimizers``: the states sharded
over the ``sharding`` axis); ``meta_parallel`` has the pipeline, the
group-sharded wrappers and ``SegmentParallel``; ``context_parallel``
the ring and Ulysses attention, ``pipeline_spmd`` and
``pipeline_spmd_engine`` the pipeline as one function over the ``pp``
axis. Not here yet, each raising and naming its part of ROADMAP queue A
item 4 (f): the parameter server (``init`` without ``is_collective``,
``init_server`` / ``init_worker`` and their kin), the data generators
and elastic launch.
"""
from __future__ import annotations

from . import (context_parallel, meta_optimizers,  # noqa: F401
               meta_parallel, mp_layers, pipeline_spmd, pipeline_spmd_engine,
               sequence_parallel, topology, utils)
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from .sequence_parallel import (  # noqa: F401
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group, set_hybrid_communicate_group)

__all__ = [
    "init", "DistributedStrategy", "distributed_model",
    "distributed_optimizer", "get_hybrid_communicate_group",
    "HybridCommunicateGroup", "CommunicateTopology", "worker_index",
    "worker_num", "is_first_worker", "barrier_worker", "is_server",
    "is_worker", "init_server", "run_server", "init_worker", "stop_worker",
    "server_endpoints", "Fleet", "fleet",
]


class DistributedStrategy:
    """Paddle's ``fleet.DistributedStrategy``: hybrid degrees and feature
    switches."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.lamb = False
        self.dgc = False
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.without_graph_optimization = True

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


_fleet_state = {"initialized": False, "strategy": None}


def _later_part(what, part):
    raise NotImplementedError(
        f"fleet: {what} comes with ROADMAP.md queue A item 4 ({part})")


def init(role_maker=None, is_collective: bool = False, strategy=None,
         log_level="INFO"):
    """Collective ``fleet.init`` (module docstring); returns the hybrid
    group. The parameter-server mode raises (ROADMAP queue A item 4
    (f))."""
    from .. import env

    if not is_collective and not (
            role_maker is not None
            and getattr(role_maker, "_is_collective", False)):
        _later_part("the parameter-server mode (init without "
                    "is_collective=True)", "f")
    env.init_parallel_env()
    strategy = strategy or DistributedStrategy()
    hc = dict(strategy.hybrid_configs)
    dims = {n: int(hc.get(f"{n}_degree", 1))
            for n in ("pp", "dp", "sharding", "sep", "mp")}
    world = env.get_world_size()
    others = dims["pp"] * dims["sharding"] * dims["sep"] * dims["mp"]
    if dims["dp"] == 1 and others and world % others == 0:
        dims["dp"] = world // others
    topo = CommunicateTopology(list(dims), list(dims.values()))
    hcg = HybridCommunicateGroup(topo)
    set_hybrid_communicate_group(hcg)
    _fleet_state["initialized"] = True
    _fleet_state["strategy"] = strategy
    return hcg


def distributed_model(model):
    """The model for the hybrid group: at a pipeline degree above 1 a
    ``PipelineLayer`` wrapped in ``PipelineParallel`` (its stages over
    the pp ranks). Any other model has every parameter not yet sharded
    replicated over the hybrid mesh, and is wrapped at a sep degree
    above 1 in ``SegmentParallel`` (which sums the gradients over sep
    and averages them over dp), else at a data-parallel degree above 1
    in ``DataParallel`` over the dp group."""
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return model
    strategy = _fleet_state.get("strategy")
    from .meta_parallel import PipelineLayer, PipelineParallel

    if isinstance(model, PipelineLayer) \
            and hcg.get_pipe_parallel_world_size() > 1:
        return PipelineParallel(model, hcg, strategy=strategy)
    from ..auto_parallel.api import DistParameter, shard_tensor
    from ..auto_parallel.placement import Replicate

    mesh = hcg.mesh
    for p in model.parameters():
        if not isinstance(p, DistParameter):
            shard_tensor(p, mesh, [Replicate()] * mesh.ndim)
    if hcg.get_sep_parallel_world_size() > 1:
        from .meta_parallel import SegmentParallel

        return SegmentParallel(model, hcg)
    if hcg.get_data_parallel_world_size() > 1:
        from ..parallel_wrapper import DataParallel

        model = DataParallel(
            model, strategy=strategy,
            group=hcg.get_data_parallel_group(),
            find_unused_parameters=bool(getattr(
                strategy, "find_unused_parameters", False)))
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer as it is at a sharding degree of 1: its
    ``ClipGradByGlobalNorm`` already sums sharded gradients over their
    mesh axes. Above 1 Paddle's ``HybridParallelOptimizer``, its states
    sharded over the ``sharding`` axis (``meta_optimizers``)."""
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        from .meta_optimizers import HybridParallelOptimizer

        return HybridParallelOptimizer(
            optimizer, hcg, strategy or _fleet_state.get("strategy"))
    return optimizer


def _ps(*args, **kwargs):
    _later_part("the parameter server (init_server, run_server, "
                "init_worker, stop_worker)", "f")


init_server = run_server = init_worker = stop_worker = _ps


def is_server():
    return False


def is_worker():
    return True


def server_endpoints():
    return []


def worker_index():
    from .. import env

    return env.get_rank()


def worker_num():
    from .. import env

    return env.get_world_size()


def is_first_worker():
    return worker_index() == 0


def barrier_worker():
    from .. import env

    env.barrier()


class Fleet:
    """The class form of the module's functions (Paddle's ``Fleet``)."""

    def init(self, role_maker=None, is_collective=False, strategy=None,
             log_level="INFO"):
        init(role_maker, is_collective, strategy, log_level)
        return self

    def is_first_worker(self):
        return is_first_worker()

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def is_worker(self):
        return is_worker()

    def is_server(self):
        return is_server()

    def barrier_worker(self):
        return barrier_worker()

    def distributed_model(self, model):
        return distributed_model(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    def get_hybrid_communicate_group(self):
        return get_hybrid_communicate_group()


fleet = Fleet()
