"""``global_scatter`` / ``global_gather``.

Counterpart of ``paddle_tpu/distributed/utils/moe_utils.py`` (after
Paddle's ``moe_utils.py``: an alltoall that moves variable-length groups
of rows between ranks by ``local_count`` / ``global_count``). As in the
reference, only a one-rank group is served, where both are the identity
over the rows (each expert's rows already contiguous); a larger group
raises. The MoE layers route with their own dense dispatch.
"""
from __future__ import annotations

from ..communication import _check_single_rank

__all__ = ["global_scatter", "global_gather"]


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    _check_single_rank(group, "global_scatter")
    return x.clone()


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    _check_single_rank(group, "global_gather")
    return x.clone()
