"""``paddle.optimizer`` subset of the port: SGD, Adam and AdamW over
torch parameters, with fp32 master weights under ``multi_precision``."""
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
