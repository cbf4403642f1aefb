"""``paddle.vision`` of the port: the model zoo (``vision.models``). The
reference's detection ops (``vision/ops.py``), datasets and transforms
wait for ``ROADMAP.md`` queue A."""
from . import models
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ["models", *_models_all]
