"""paddle_tpu_torch.utils — the ported part of ``paddle.utils``.

Counterpart of ``paddle_tpu/utils/__init__.py``; so far only FLOPs
accounting (``flops.py``: ``flops``, ``register_flops``,
``dynamic_flops``, ``count_flops``). The rest of the reference's
``utils`` waits for ROADMAP queue A.
"""
from __future__ import annotations

from . import flops as _flops_mod  # noqa: F401
from .flops import count_flops, dynamic_flops, flops, register_flops

__all__ = ["flops", "register_flops", "dynamic_flops", "count_flops"]
