"""Concrete optimizers: SGD, Adam, AdamW.

Counterpart of ``paddle_tpu/optimizer/optimizers.py`` (``_sgd_update``,
``_adam_update``, ``_adamw_update``): the same arithmetic, in place on
fp32 tensors. Bias correction uses ``t = step_count + 1``; AdamW applies
its decoupled decay ``p *= 1 - lr * weight_decay`` before the moment
update. ``apply_decay_param_fun`` and ``lr_ratio`` are refused until the
slice that ports them.
"""
from __future__ import annotations

from .optimizer import Optimizer, _later

__all__ = ["SGD", "Adam", "AdamW"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_param(self, p, grad, lr):
        master = self._master(p)
        if master is not None:
            master.sub_(lr * grad.float())
            p.copy_(master)
        else:
            p.sub_(lr * grad.to(p.dtype))


class Adam(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _adam(self, p, p32, grad, lr):
        b1, b2 = self._beta1, self._beta2
        t = self._step_count + 1
        g32 = grad.float()
        m = self._accum("moment1", p)
        v = self._accum("moment2", p)
        m.mul_(b1).add_(g32, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
        mhat = m / (1.0 - b1 ** t)
        vhat = v / (1.0 - b2 ** t)
        p32.sub_(lr * mhat / (vhat.sqrt_() + self._epsilon))

    def _update_param(self, p, grad, lr):
        master = self._master(p)
        p32 = self._fp32(p, master)
        self._adam(p, p32, grad, lr)
        self._write_back(p, p32, master)


class AdamW(Adam):
    """Adam with decoupled weight decay (reference
    ``optimizer/adamw.py``: the decay scales the parameter directly)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise _later("AdamW lr_ratio")
        if apply_decay_param_fun is not None:
            raise _later("AdamW apply_decay_param_fun")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._weight_decay = float(weight_decay)

    def _update_param(self, p, grad, lr):
        master = self._master(p)
        p32 = self._fp32(p, master)
        p32.mul_(1.0 - lr * self._weight_decay)
        self._adam(p, p32, grad, lr)
        self._write_back(p, p32, master)
