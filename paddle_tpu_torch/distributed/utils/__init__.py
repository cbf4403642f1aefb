from .moe_utils import global_gather, global_scatter  # noqa: F401
