"""``fleet.meta_optimizers`` of the port: the dygraph hybrid-parallel
optimizers.

Counterpart of ``paddle_tpu/distributed/fleet/meta_optimizers/__init__.py``.
"""
from .dygraph_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, HybridParallelOptimizer)
