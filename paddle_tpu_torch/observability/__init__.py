"""paddle_tpu_torch.observability — the metrics registry.

The minimum of ``paddle_tpu/observability`` the serving engine needs:
``registry`` and the define-or-get ``counter`` / ``gauge`` /
``histogram``. Tracing (``tracing.py``), SLOs (``slo.py``), health and
the rest of the plane are not ported yet.
"""
from __future__ import annotations

from .metrics import registry

__all__ = ["registry", "counter", "gauge", "histogram"]

counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram
