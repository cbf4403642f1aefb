"""``paddle.incubate.distributed`` of the port: the MoE models."""
from . import models  # noqa: F401
