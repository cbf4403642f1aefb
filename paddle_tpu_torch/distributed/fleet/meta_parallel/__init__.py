"""``fleet.meta_parallel`` of the port: the pipeline (``LayerDesc``,
``SharedLayerDesc``, ``PipelineLayer``, ``PipelineParallel``,
``pipeline_spmd_apply``), context parallelism's ``SegmentParallel``, the
group-sharded (ZeRO) wrappers and the sequence-parallel names.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/__init__.py``.
"""
from __future__ import annotations

from ..pipeline_spmd import pipeline_spmd_apply  # noqa: F401
from ..sequence_parallel import *  # noqa: F401,F403
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .segment_parallel import SegmentParallel  # noqa: F401
from .sharding import (GroupShardedOptimizerStage2,  # noqa: F401
                       GroupShardedStage2, GroupShardedStage3)

__all__ = [
    "LayerDesc", "SharedLayerDesc", "PipelineLayer", "PipelineParallel",
    "SegmentParallel",
    "GroupShardedOptimizerStage2", "GroupShardedStage2", "GroupShardedStage3",
    "pipeline_spmd_apply",
]
