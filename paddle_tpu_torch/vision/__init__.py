"""``paddle.vision`` of the port: the ResNet family
(``vision.models``). The reference's other vision models, datasets and
transforms wait for ``ROADMAP.md`` queue A."""
from . import models
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ["models", *_models_all]
