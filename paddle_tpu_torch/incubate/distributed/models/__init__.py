"""``paddle.incubate.distributed.models`` of the port."""
from . import moe  # noqa: F401
