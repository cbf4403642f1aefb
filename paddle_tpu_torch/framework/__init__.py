"""``paddle.framework`` of the port: ``save`` and ``load``.

Counterpart of ``paddle_tpu/framework/__init__.py``.
"""
from .io_ import load, save  # noqa: F401

__all__ = ["save", "load"]
