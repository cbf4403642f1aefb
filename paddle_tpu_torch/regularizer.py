"""Weight regularizers.

Counterpart of ``paddle_tpu/regularizer.py``: ``L1Decay`` and ``L2Decay``
add ``coeff * sign(param)`` or ``coeff * param`` to the gradient. The
optimizer applies one after clipping: the parameter's own
``regularizer`` when it carries one, else the optimizer's
``weight_decay``. Here ``_apply`` takes the gradients of every parameter
that shares the regularizer and adds its term to all of them in one
multi-tensor op (the reference applies it per parameter), in each
gradient's dtype as the reference computes it: the coefficient rounded
to that dtype, the product rounded, then the sum. The result is new
tensors; the gradients are left as they are.
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


def _in_grad_dtypes(params, grads):
    return [p if p.dtype == g.dtype else p.to(g.dtype)
            for p, g in zip(params, grads)]


def _add_scaled(grads, terms, coeff):
    """``grads + coeff * terms``, the coefficient in each gradient's
    dtype."""
    coeffs = [torch.tensor(coeff, dtype=g.dtype).item() for g in grads]
    return torch._foreach_add(grads, torch._foreach_mul(terms, coeffs))


class WeightDecayRegularizer:
    def _apply(self, params, grads):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _apply(self, params, grads):
        return _add_scaled(grads, _in_grad_dtypes(params, grads),
                           self.coeff)


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def _apply(self, params, grads):
        signs = torch._foreach_sign(_in_grad_dtypes(params, grads))
        return _add_scaled(grads, signs, self.coeff)
