"""The one-boolean hot-path gate.

The port's copy of ``paddle_tpu/observability/_gate.py``. Instrumented
modules read ``state.on`` (two attribute loads, no call) before
recording a structured event, so a disabled build adds nanoseconds to
the hot path. Kept in its own leaf module so ``events``, ``flight`` and
``observability/__init__`` can share it without import cycles.
"""
from __future__ import annotations


class _State:
    __slots__ = ("on",)

    def __init__(self):
        self.on = False


state = _State()
