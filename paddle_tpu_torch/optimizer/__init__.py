"""``paddle.optimizer`` of the port: every optimizer of the reference
but LBFGS, over torch parameters, with fp32 master weights under
``multi_precision``, and the learning-rate schedulers (``optimizer.lr``).
Adam and AdamW update all parameters at once in multi-tensor ops."""
from . import lr
from .extra_optimizers import ASGD, NAdam, RAdam, Rprop
from .optimizer import Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                         Momentum, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "RMSProp",
           "Adagrad", "Adadelta", "Adamax", "Lamb", "ASGD", "RAdam", "Rprop",
           "NAdam", "lr"]
