"""Concrete optimizers: SGD, Momentum, Adam, AdamW, RMSProp, Adagrad,
Adadelta, Adamax, Lamb.

Counterpart of ``paddle_tpu/optimizer/optimizers.py``: the same
arithmetic, in place on fp32 tensors, bias correction with
``t = step_count + 1``. The reference jits one fused update per
parameter, "the multi-tensor-apply analog"; here Adam and AdamW update
every parameter at once in ``torch._foreach_*`` ops (``_adam_foreach``),
grouped by (device, parameter dtype, has a master), with each
parameter's rate and decay in scalar lists. That is their one path, on
the CPU too. The other optimizers update per parameter in plain torch.
In a captured step (``optimizer.py``'s docstring) the rate and the bias
corrections are fp32 device scalars: Adam then applies each one in one
multi-tensor op over the parameters that share it
(:func:`_adam_foreach_device`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.foreach import fp32_copies, norm_fp32
from .optimizer import Optimizer, _bias_correction, _one_minus

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "RMSProp", "Adagrad",
           "Adadelta", "Adamax", "Lamb"]


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
            # the reference casts lr to the parameter's dtype here
            lr = (lr.to(p.dtype) if isinstance(lr, torch.Tensor)
                  else torch.tensor(lr, dtype=p.dtype).item())
            p.sub_(lr * grad.to(p.dtype))


class Momentum(Optimizer):
    _accum_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _update_param(self, p, grad, lr):
        mu = self._momentum
        g32 = grad.float()
        vel = self._accum("velocity", p)
        vel.mul_(mu).add_(g32)
        upd = g32 + mu * vel if self._use_nesterov else vel
        p32 = self._fp32(p)
        p32.sub_(lr * upd)
        self._write_back(p, p32)


def _adam_foreach(ps, p32, g32, m, v, lrs, wds, b1, b2, eps, t):
    """One Adam/AdamW step over lists, in place on ``p32`` (fp32 masters or
    parameters), ``m`` and ``v``: ``_adamw_update``'s arithmetic (the
    decoupled decay ``p *= 1 - lr * wd`` first where ``wds`` is given),
    with the bias corrections folded into the scalars:
    ``p -= (lr / bc1) * m / (sqrt(v) / sqrt(bc2) + eps)``. Then ``ps``
    receive ``p32`` cast, where they are not ``p32`` themselves."""
    bc1, bc2 = _bias_correction(b1, t), _bias_correction(b2, t)
    if isinstance(bc1, torch.Tensor):
        _adam_foreach_device(ps, p32, g32, m, v, lrs, wds, b1, b2, eps, bc1,
                             bc2)
        return
    if wds is not None and any(wds):
        torch._foreach_mul_(p32, [1.0 - lr * wd for lr, wd in zip(lrs, wds)])
    torch._foreach_lerp_(m, g32, _one_minus(b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g32, g32, value=_one_minus(b2))
    denom = torch._foreach_sqrt(v)
    torch._foreach_div_(denom, math.sqrt(bc2))
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(p32, m, denom, [-lr / bc1 for lr in lrs])
    if p32 is not ps:
        torch._foreach_copy_(ps, p32)


def _mul_by(tensors, scalars):
    """``tensors[i] *= scalars[i]`` in place, one multi-tensor op per
    distinct scalar (device scalars by identity)."""
    groups: dict = {}
    for t, c in zip(tensors, scalars):
        groups.setdefault(id(c), (c, []))[1].append(t)
    for c, ts in groups.values():
        torch._foreach_mul_(ts, c)


def _adam_foreach_device(ps, p32, g32, m, v, lrs, wds, b1, b2, eps, bc1,
                         bc2):
    """:func:`_adam_foreach` in a captured step: the rates (``lrs``) and
    the bias corrections are fp32 device scalars, so the decay factor and
    the step size ``s = -lr / bc1`` are fp32 device scalars too, one per
    distinct rate. ``addcdiv`` takes no device scalar, so the denominator
    is divided by ``s``: ``p += m / ((sqrt(v) / sqrt(bc2) + eps) / s)``,
    one pass more than the eager update, its value within a few
    roundings. (``_foreach_add_`` of a device scalar reads it on the host,
    which a capture cannot; multiplying and dividing by one does not.)
    Parameters without decay are not multiplied by 1."""
    memo: dict = {}

    def per_rate(lr, key, fn):
        if (id(lr), key) not in memo:
            memo[id(lr), key] = fn(lr)
        return memo[id(lr), key]

    if wds is not None and any(wds):
        idx = [i for i, wd in enumerate(wds) if wd]
        _mul_by([p32[i] for i in idx],
                [per_rate(lrs[i], wds[i], lambda x, wd=wds[i]: 1.0 - x * wd)
                 for i in idx])
    torch._foreach_lerp_(m, g32, _one_minus(b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g32, g32, value=_one_minus(b2))
    denom = torch._foreach_sqrt(v)
    torch._foreach_div_(denom, torch.sqrt(bc2))
    torch._foreach_add_(denom, eps)
    _mul_by(denom, [per_rate(lr, "step", lambda x: -bc1 / x) for lr in lrs])
    torch._foreach_addcdiv_(p32, m, denom)
    if p32 is not ps:
        torch._foreach_copy_(ps, p32)


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

    def _update(self, params, grads, lrs, wds=None):
        """Every parameter at once, one :func:`_adam_foreach` per
        (device, dtype, has a master) group."""
        groups: dict = {}
        for i, p in enumerate(params):
            key = (p.device, p.dtype, self._master(p) is not None)
            groups.setdefault(key, []).append(i)
        t = self._t()
        for (_, dtype, has_master), idx in groups.items():
            ps = [params[i] for i in idx]
            gs = [grads[i] for i in idx]
            if has_master:
                p32 = [self._master_weights[id(p)] for p in ps]
            else:
                p32 = ps if dtype == torch.float32 else fp32_copies(ps)
            if any(g.dtype != torch.float32 for g in gs):
                gs = fp32_copies(gs)
            _adam_foreach(ps, p32, gs,
                          [self._accum("moment1", p) for p in ps],
                          [self._accum("moment2", p) for p in ps],
                          [lrs[i] for i in idx],
                          None if wds is None else [wds[i] for i in idx],
                          self._beta1, self._beta2, self._epsilon, t)


class AdamW(Adam):
    """Adam with decoupled weight decay (reference
    ``optimizer/adamw.py``: the decay scales the parameter directly).
    ``apply_decay_param_fun(name)`` false spares a parameter from the
    decay (its name as in ``optimizer.py``'s docstring); ``lr_ratio(p)``
    scales a parameter's rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._weight_decay = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update(self, params, grads, lrs):
        names = self._names()
        decay = self._apply_decay_param_fun
        wds = [self._weight_decay if decay is None or decay(names[id(p)])
               else 0.0 for p in params]
        if self._lr_ratio is not None:
            lrs = [lr * self._lr_ratio(p) for p, lr in zip(params, lrs)]
        super()._update(params, grads, lrs, wds)


class RMSProp(Optimizer):
    _accum_names = ("mean_square", "momentum", "mean_grad")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)

    def _update_param(self, p, grad, lr):
        rho = self._rho
        g32 = grad.float()
        ms = self._accum("mean_square", p)
        mom = self._accum("momentum", p)
        mg = self._accum("mean_grad", p)
        ms.mul_(rho).addcmul_(g32, g32, value=_one_minus(rho))
        if self._centered:
            mg.mul_(rho).add_(g32, alpha=_one_minus(rho))
            denom = (ms - mg * mg + self._epsilon).sqrt_()
        else:
            denom = (ms + self._epsilon).sqrt_()
        mom.mul_(self._momentum).add_(lr * g32 / denom)
        p32 = self._fp32(p)
        p32.sub_(mom)
        self._write_back(p, p32)


class Adagrad(Optimizer):
    _accum_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _accum_fill(self, name):
        return self._init_acc if name == "moment" else 0.0

    def _update_param(self, p, grad, lr):
        g32 = grad.float()
        m = self._accum("moment", p, fill=self._init_acc)
        m.addcmul_(g32, g32)
        p32 = self._fp32(p)
        p32.sub_(lr * g32 / (m.sqrt() + self._epsilon))
        self._write_back(p, p32)


class Adadelta(Optimizer):
    _accum_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = float(epsilon)
        self._rho = float(rho)

    def _update_param(self, p, grad, lr):
        rho, eps = self._rho, self._epsilon
        g32 = grad.float()
        sq_g = self._accum("avg_squared_grad", p)
        sq_u = self._accum("avg_squared_update", p)
        sq_g.mul_(rho).addcmul_(g32, g32, value=_one_minus(rho))
        upd = (sq_u + eps).sqrt_() / (sq_g + eps).sqrt_() * g32
        sq_u.mul_(rho).addcmul_(upd, upd, value=_one_minus(rho))
        p32 = self._fp32(p)
        p32.sub_(lr * upd)
        self._write_back(p, p32)


class Adamax(Optimizer):
    _accum_names = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _update_param(self, p, grad, lr):
        b1, t = self._beta1, self._t()
        g32 = grad.float()
        m = self._accum("moment", p)
        inf = self._accum("inf_norm", p)
        m.mul_(b1).add_(g32, alpha=_one_minus(b1))
        torch.maximum(inf.mul_(self._beta2), g32.abs(), out=inf)
        p32 = self._fp32(p)
        bc = _bias_correction(b1, t)
        if isinstance(bc, torch.Tensor) or isinstance(lr, torch.Tensor):
            step = lr / bc
        else:
            step = float(np.float32(lr) / np.float32(bc))
        p32.sub_(step * m / (inf + self._epsilon))
        self._write_back(p, p32)


class Lamb(Optimizer):
    """Layer-wise adaptive Adam; ``exclude_from_weight_decay_fn(p)`` true
    spares a parameter from the decay."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, grad, lr):
        b1, b2, t = self._beta1, self._beta2, self._t()
        g32 = grad.float()
        m = self._accum("moment1", p)
        v = self._accum("moment2", p)
        m.mul_(b1).add_(g32, alpha=_one_minus(b1))
        v.mul_(b2).addcmul_(g32, g32, value=_one_minus(b2))
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        p32 = self._fp32(p)
        r = (m / _bias_correction(b1, t)) / (
            (v / _bias_correction(b2, t)).sqrt_() + self._epsilon) + wd * p32
        w_norm, r_norm = norm_fp32(p32), norm_fp32(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p32.sub_(lr * ratio * r)
        self._write_back(p, p32)
