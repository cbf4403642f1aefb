"""``fleet.meta_parallel`` of the port: the group-sharded (ZeRO) wrappers
and the sequence-parallel names.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/__init__.py``.
The pipeline (``LayerDesc``, ``SharedLayerDesc``, ``PipelineLayer``,
``PipelineParallel``, ``pipeline_spmd_apply``) is ROADMAP queue A item
4 (e) and ``SegmentParallel`` (context parallelism) item 4 (d): each
raises, naming its part.
"""
from __future__ import annotations

from ..sequence_parallel import *  # noqa: F401,F403
from .sharding import (GroupShardedOptimizerStage2,  # noqa: F401
                       GroupShardedStage2, GroupShardedStage3)

__all__ = [
    "LayerDesc", "SharedLayerDesc", "PipelineLayer", "PipelineParallel",
    "SegmentParallel",
    "GroupShardedOptimizerStage2", "GroupShardedStage2", "GroupShardedStage3",
    "pipeline_spmd_apply",
]


def _later(what, part):
    raise NotImplementedError(
        f"fleet.meta_parallel: {what} comes with ROADMAP.md queue A item 4 "
        f"({part})")


class _Later:
    _what, _part = "", ""

    def __init__(self, *args, **kwargs):
        _later(self._what, self._part)


class LayerDesc(_Later):
    _what, _part = "LayerDesc (the pipeline)", "e"


class SharedLayerDesc(_Later):
    _what, _part = "SharedLayerDesc (the pipeline)", "e"


class PipelineLayer(_Later):
    _what, _part = "PipelineLayer (the pipeline)", "e"


class PipelineParallel(_Later):
    _what, _part = "PipelineParallel (the pipeline)", "e"


class SegmentParallel(_Later):
    _what, _part = "SegmentParallel (context parallelism)", "d"


def pipeline_spmd_apply(*args, **kwargs):
    _later("pipeline_spmd_apply (the pipeline)", "e")
