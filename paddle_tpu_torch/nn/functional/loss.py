"""Loss functional ops (the hard-label ``cross_entropy`` subset).

Counterpart of ``paddle_tpu/nn/functional/loss.py::cross_entropy`` on the
path the unfused Llama loss takes: integer labels over the last axis,
softmax applied, ``ignore_index`` entries dropped, and the mean taken
over the valid tokens (``sum / max(count, 1)``, the reference's
``reduction="mean"``). The log-softmax runs in the logits' dtype, as the
reference's does. The reference leaves it to XLA, so it is plain PyTorch
here. Soft labels, class weights, label smoothing, ``use_softmax=False``,
other axes and other reductions raise until a slice needs them.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Mean hard-label softmax cross-entropy of ``input`` [..., C] against
    integer ``label`` [...] (or [..., 1])."""
    if (weight is not None or soft_label or not use_softmax
            or label_smoothing > 0.0 or axis not in (-1, input.ndim - 1)
            or reduction != "mean"):
        raise NotImplementedError(
            "cross_entropy: only the mean over hard labels on the last "
            "axis, with softmax, no class weight and no label smoothing, "
            "is ported")
    if label.ndim == input.ndim and label.shape[-1] == 1:
        label = label[..., 0]
    logp = torch.log_softmax(input, dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, nll, torch.zeros_like(nll))
    return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1)
