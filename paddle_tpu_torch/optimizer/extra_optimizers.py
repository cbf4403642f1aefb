"""ASGD, RAdam, Rprop and NAdam.

Counterpart of ``paddle_tpu/optimizer/extra_optimizers.py``: the same
arithmetic per parameter in plain torch, in place on fp32 tensors.
ASGD keeps its window of the last ``batch_num`` gradients as one
``[n, *shape]`` accumulator whose write position comes from the shared
step count; Rprop zeroes the step where the gradient's sign flipped;
NAdam's ``mu_product`` starts at ones. RAdam's and NAdam's schedule
scalars are computed in fp32, as the reference computes them from its
fp32 step count: RAdam's rectification at beta2 0.999 subtracts two
numbers near 2000, so an fp64 evaluation would move the step by more
than fp32 rounding. In a captured step (``optimizer.py``'s docstring)
those scalars and ASGD's window slot come from the device step count, in
fp32 on the device, and RAdam picks its branch per step with a
``torch.where``.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer, _bias_correction

__all__ = ["ASGD", "RAdam", "Rprop", "NAdam"]

_f32 = np.float32


class ASGD(Optimizer):
    """Averaged SGD: ``d = d - y_old + g`` over a window of ``batch_num``
    gradients, ``p -= lr * d / n``."""

    _accum_names = ("d", "grad_window")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        if batch_num <= 0:
            raise ValueError("batch_num must be positive")
        self._n = int(batch_num)

    def _window(self, p):
        windows = self._accumulators["grad_window"]
        if id(p) not in windows:
            windows[id(p)] = torch.zeros((self._n, *p.shape),
                                         dtype=torch.float32, device=p.device)
        return windows[id(p)]

    def _ensure_accumulators(self):
        for p in self._parameter_list:
            if p.requires_grad:
                self._master(p)
                self._accum("d", p)
                self._window(p)

    def _update_param(self, p, grad, lr):
        g32 = grad.float()
        d = self._accum("d", p)
        window = self._window(p)
        t = self._t()
        if isinstance(t, torch.Tensor):
            # the slot of a captured step comes from the device step count
            slot = ((t.long() - 1) % self._n).reshape(1)
            d.sub_(window.index_select(0, slot)[0]).add_(g32)
            window.index_copy_(0, slot, g32[None])
        else:
            y = window[(t - 1) % self._n]
            d.sub_(y).add_(g32)
            y.copy_(g32)
        p32 = self._fp32(p)
        p32.sub_(lr * d / self._n)
        self._write_back(p, p32)


class RAdam(Optimizer):
    """Rectified Adam: the adaptive step only where the variance of the
    adaptive rate is tractable (``rho_t > 5``), else the bias-corrected
    momentum alone."""

    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._eps = float(epsilon)

    def _update_param(self, p, grad, lr):
        b1, b2 = self._beta1, self._beta2
        g32 = grad.float()
        m = self._accum("moment1", p)
        v = self._accum("moment2", p)
        m.mul_(b1).add_(g32, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
        if isinstance(self._t(), torch.Tensor):
            step = self._device_step(m, v)
            p32 = self._fp32(p)
            p32.sub_(lr * step)
            self._write_back(p, p32)
            return
        one, t = _f32(1.0), _f32(self._t())
        b1t, b2t = _f32(b1) ** t, _f32(b2) ** t
        step = m / float(one - b1t)
        rho_inf = _f32(2.0 / (1.0 - b2) - 1.0)
        rho_t = rho_inf - _f32(2.0) * t * b2t / (one - b2t)
        if rho_t > 5.0:
            r = np.sqrt(np.maximum(
                (rho_t - _f32(4)) * (rho_t - _f32(2)) * rho_inf
                / np.maximum((rho_inf - _f32(4)) * (rho_inf - _f32(2))
                             * rho_t, _f32(1e-12)), _f32(0)))
            step = float(r) * step / ((v / float(one - b2t)).sqrt_()
                                      + self._eps)
        p32 = self._fp32(p)
        p32.sub_(lr * step)
        self._write_back(p, p32)


    def _device_step(self, m, v):
        """The step of a captured update: the host branch's fp32
        arithmetic on the device step count, both branches computed and
        the rectified one taken where ``rho_t > 5``."""
        b1, b2, t = self._beta1, self._beta2, self._t()
        b1t = torch.pow(float(_f32(b1)), t)
        b2t = torch.pow(float(_f32(b2)), t)
        step = m / (1.0 - b1t)
        rho_inf = float(_f32(2.0 / (1.0 - b2) - 1.0))
        rho_t = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
        r = torch.sqrt(torch.clamp(
            (rho_t - 4.0) * (rho_t - 2.0) * rho_inf
            / torch.clamp((rho_inf - 4.0) * (rho_inf - 2.0) * rho_t,
                          min=1e-12), min=0.0))
        adaptive = r * step / ((v / (1.0 - b2t)).sqrt_() + self._eps)
        return torch.where(rho_t > 5.0, adaptive, step)


class Rprop(Optimizer):
    """Resilient backprop: a per-weight step that grows by ``etas[1]``
    while the gradient keeps its sign and shrinks by ``etas[0]`` when it
    flips, within ``learning_rate_range``; a flip zeroes that step."""

    _accum_names = ("prev_grad", "learning_rate_step")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas
        self._init_lr = learning_rate

    def _update_param(self, p, grad, lr):
        g32 = grad.float()
        prev = self._accum("prev_grad", p)
        steps = self._accum("learning_rate_step", p)
        steps.masked_fill_(steps == 0.0, self._init_lr)
        sign = torch.sign(prev * g32)
        steps.mul_(torch.where(sign > 0, self._eta_pos,
                               torch.where(sign < 0, self._eta_neg, 1.0)))
        steps.clamp_(self._lr_min, self._lr_max)
        prev.copy_(torch.where(sign < 0, 0.0, g32))
        p32 = self._fp32(p)
        p32.sub_(steps * torch.sign(prev))
        self._write_back(p, p32)


class NAdam(Optimizer):
    """Adam with Nesterov momentum and the ``mu_product`` schedule."""

    _accum_names = ("moment1", "moment2", "mu_product")
    _accum_fills = {"mu_product": 1.0}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._eps = float(epsilon)
        self._psi = float(momentum_decay)

    def _update_param(self, p, grad, lr):
        b1, b2, t = self._beta1, self._beta2, self._t()
        g32 = grad.float()
        mu_t, mu_t1 = (_nadam_mu(b1, s, self._psi) for s in (t, t + 1))
        mu_prod = self._accum("mu_product", p, fill=1.0).mul_(mu_t)
        m = self._accum("moment1", p)
        v = self._accum("moment2", p)
        m.mul_(b1).add_(g32, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
        m_hat = (mu_t1 * m / (1.0 - mu_prod * mu_t1)
                 + (1.0 - mu_t) * g32 / (1.0 - mu_prod))
        p32 = self._fp32(p)
        p32.sub_(lr * m_hat / ((v / _bias_correction(b2, t)).sqrt_()
                               + self._eps))
        self._write_back(p, p32)


def _nadam_mu(b1, s, psi):
    """NAdam's ``mu`` at step ``s`` in fp32: a float for a host step, a
    device scalar for a captured step's."""
    if isinstance(s, torch.Tensor):
        return float(_f32(b1)) * (1.0 - 0.5 * torch.pow(
            float(_f32(0.96)), s * float(_f32(psi))))
    return float(_f32(b1) * (_f32(1) - _f32(0.5) * _f32(0.96) ** (
        _f32(s) * _f32(psi))))
