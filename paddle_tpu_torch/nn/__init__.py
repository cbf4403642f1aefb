"""Neural-network functional ops, gradient clipping and ``nn.utils`` of
the port; layers are ``torch.nn``."""
from . import functional, utils
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["functional", "utils", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue"]
