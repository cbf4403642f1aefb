"""paddle_tpu_torch.static — the port's counterpart of ``paddle_tpu/static``.

Only the diagnostics layer is ported so far (``static.analysis``: the
coded diagnostic records and the serve-trace lint the serving plane's
tracing and SLO monitors report through). ``Program``, ``Executor``, the
verifier, the lints and the cost model wait for ROADMAP queue A item 7.
"""
from __future__ import annotations

from . import analysis  # noqa: F401
from .analysis import ProgramVerificationError  # noqa: F401

__all__ = ["analysis", "ProgramVerificationError"]
