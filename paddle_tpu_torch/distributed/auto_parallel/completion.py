"""Placement completion: ``complete_placements``, ``derive_shard_plan``
and ``search_shard_plans``.

Counterpart of ``paddle_tpu/distributed/auto_parallel/completion.py``,
which walks a captured program's ops through the SPMD rules. The port
has no static ``Program`` yet, so each entry point raises, naming
ROADMAP queue A item 7.
"""
from __future__ import annotations

__all__ = ["PlanSearchResult", "ScoredPlan", "complete_placements",
           "derive_shard_plan", "search_shard_plans"]


def _item7(name):
    raise NotImplementedError(
        f"auto_parallel.{name} reads a captured static Program, which "
        f"comes with ROADMAP.md queue A item 7")


def complete_placements(*args, **kwargs):
    _item7("complete_placements")


def derive_shard_plan(*args, **kwargs):
    _item7("derive_shard_plan")


def search_shard_plans(*args, **kwargs):
    _item7("search_shard_plans")


class ScoredPlan:
    def __init__(self, *args, **kwargs):
        _item7("ScoredPlan")


class PlanSearchResult:
    def __init__(self, *args, **kwargs):
        _item7("PlanSearchResult")
