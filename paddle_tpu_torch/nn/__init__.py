"""Neural-network functional ops of the port; layers are ``torch.nn``."""
from . import functional

__all__ = ["functional"]
