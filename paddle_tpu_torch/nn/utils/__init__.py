"""``paddle.nn.utils`` subset of the port: ``clip_grad_norm_`` and
``clip_grad_value_``.

Counterpart of ``paddle_tpu/nn/utils/__init__.py:186-230``. Unlike the
pair in ``nn/clip.py``, ``clip_grad_norm_`` honours
``error_if_nonfinite`` (one host read of the total norm, only when it is
set) and ``clip_grad_value_`` clamps into ``[-|v|, |v|]``.
"""
from __future__ import annotations

from ..clip import _clip_grad_norm, _clip_grad_value

__all__ = ["clip_grad_norm_", "clip_grad_value_"]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale gradients in place so their total norm is at most
    ``max_norm``; returns the total norm before clipping. Raises
    ``RuntimeError`` on a non-finite total when ``error_if_nonfinite``."""
    return _clip_grad_norm(parameters, float(max_norm), float(norm_type),
                           error_if_nonfinite)


def clip_grad_value_(parameters, clip_value):
    """Clamp gradients into ``[-|clip_value|, |clip_value|]`` in place."""
    cv = abs(float(clip_value))
    _clip_grad_value(parameters, -cv, cv)
