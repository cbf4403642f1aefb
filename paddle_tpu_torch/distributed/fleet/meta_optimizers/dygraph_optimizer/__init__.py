"""``DygraphShardingOptimizer`` and ``HybridParallelOptimizer``.

Counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer/__init__.py``
(Paddle's ``dygraph_sharding_optimizer.py`` and
``hybrid_parallel_optimizer.py``). Both shard the inner optimizer's
states by rows over the hybrid group's ``sharding`` axis (ZeRO-1's
memory). The ranks of that axis see different data, as Paddle's do, and
nothing else averages their gradients (``fleet.distributed_model``'s
``DataParallel`` covers the ``dp`` axis only), so each rank's gradient
rows come from a reduce-scatter over the axis at the step, as Paddle's
sharding optimizer reduces each gradient to the rank that owns it; the
updated rows are all-gathered after it, as Paddle broadcasts them
(``shard_optimizer`` at ``ShardingStage2``). At a sharding degree of 1
nothing changes. The global-norm clip sums the rows' squares over the
axis, so it is the whole model's on every rank.
"""
from __future__ import annotations

from ....auto_parallel.api import ShardingStage2, shard_optimizer
from ...topology import get_hybrid_communicate_group

__all__ = ["DygraphShardingOptimizer", "HybridParallelOptimizer"]


def _shard_over_sharding_axis(optimizer, hcg):
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        shard_optimizer(optimizer, ShardingStage2("sharding", mesh=hcg.mesh))
    return optimizer


class _Wrapper:
    def step(self):
        self._inner_opt.step()

    def minimize(self, loss, *args, **kwargs):
        self.step()

    def clear_grad(self, *args, **kwargs):
        self._inner_opt.clear_grad(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)


class DygraphShardingOptimizer(_Wrapper):
    """``optimizer`` sharded over the hybrid group's ``sharding`` axis
    (module docstring)."""

    def __init__(self, optimizer, hcg=None):
        self._hcg = hcg or get_hybrid_communicate_group()
        self._inner_opt = _shard_over_sharding_axis(optimizer, self._hcg)


class HybridParallelOptimizer(_Wrapper):
    """``fleet.distributed_optimizer``'s optimizer at a sharding degree
    above 1: the sharding of ``DygraphShardingOptimizer``; the clip is
    the inner optimizer's (its global norm already sums sharded
    gradients over their axes)."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        self._inner_opt = _shard_over_sharding_axis(optimizer, self._hcg)
