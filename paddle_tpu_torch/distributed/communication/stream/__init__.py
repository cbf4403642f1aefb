"""``paddle.distributed.communication.stream``: the stream variants of
the collectives, the reference's re-exports of the same functions
(``sync_op`` / ``use_calc_stream`` are their arguments; on the card a
synchronous collective already orders the current stream after it)."""
from __future__ import annotations

from .. import (  # noqa: F401
    all_gather, all_reduce, broadcast, gather, reduce, reduce_scatter,
    recv, scatter, send,
)
from .. import all_to_all as alltoall  # noqa: F401
from .. import all_to_all_single as alltoall_single  # noqa: F401

__all__ = [
    "all_gather", "all_reduce", "alltoall", "alltoall_single", "broadcast",
    "reduce", "reduce_scatter", "recv", "scatter", "send", "gather",
]
