"""Loss functional ops.

Counterpart of ``paddle_tpu/nn/functional/loss.py``, all 19 functions.
The reference leaves them to XLA, so they are plain PyTorch here, in
the inputs' dtype, with the reference's arithmetic and reductions:

- ``cross_entropy``: hard labels (``ignore_index`` entries give 0; the
  mean divides by the count of valid labels, at least 1; with class
  ``weight`` the mean divides by the sum of the selected weights), soft
  labels, label smoothing (hard labels one-hot first, then
  ``label_smooth``), ``use_softmax=False`` (the input is taken as
  probabilities, ``log(max(p, 1e-30))``), any ``axis`` and
  ``reduction`` ``"mean"``, ``"sum"`` or ``"none"``. The hard-label
  path the unfused Llama loss takes (mean over the last axis, softmax,
  no weight) computes the log-softmax in the logits' dtype.
- Class weights are looked up as ``jnp.take`` does: a negative label
  counts from the end and one below ``-C`` (an ignored ``-100`` with
  fewer than 100 classes) selects NaN, so a weighted loss over ignored
  labels is NaN in both packages.
- ``nll_loss``'s unweighted mean is over every entry, ignored ones
  included, as in the reference.
"""
from __future__ import annotations

import torch

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "square_error_cost",
    "sigmoid_focal_loss", "hinge_embedding_loss", "cosine_embedding_loss",
    "triplet_margin_loss", "soft_margin_loss", "multi_label_soft_margin_loss",
    "log_loss", "npair_loss",
]


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _take(w, index):
    """``jnp.take(w, index)`` with its default mode: negative indices
    count from the end, indices outside ``[-n, n)`` give NaN."""
    n = w.shape[0]
    ok = (index >= -n) & (index < n)
    picked = w[torch.where(ok, index, torch.zeros_like(index)).long() % n]
    return torch.where(ok, picked, torch.full_like(picked, float("nan")))


def _log_probs(input, axis, use_softmax):
    if use_softmax:
        return torch.log_softmax(input, dim=axis)
    return torch.log(torch.clamp(input, min=1e-30))


def _hard_nll(logp, label, axis, ignore_index):
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy of ``input`` against hard (integer, ``[...]``
    or ``[..., 1]`` on ``axis``) or soft labels."""
    axis = axis % input.ndim
    if label_smoothing > 0.0:
        if not soft_label:
            if label.ndim == input.ndim and label.shape[axis] == 1:
                label = label.squeeze(axis)
            # jax.nn.one_hot: a label outside [0, C) is a row of zeros
            classes = torch.arange(input.shape[axis], device=label.device)
            label = (label.long().unsqueeze(-1) == classes).float()
            soft_label = True
        label = label * (1.0 - label_smoothing) + (
            label_smoothing / label.shape[-1])
    logp = _log_probs(input, axis, use_softmax)
    if soft_label:
        loss = -(label.to(input.dtype) * logp).sum(dim=axis)
        return _reduce_loss(loss, reduction)
    if label.ndim == input.ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    loss, valid = _hard_nll(logp, label, axis, ignore_index)
    if weight is not None:
        wsel = _take(weight, label)
        loss = loss * wsel.to(loss.dtype)
        if reduction == "mean":
            return loss.sum() / wsel.sum()
    elif reduction == "mean":
        return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1)
    return _reduce_loss(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce_loss(torch.square(input - label), reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce_loss(torch.abs(input - label), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` [N, C] or
    [N, C, d1, ...] at integer ``label``."""
    orig_shape = None
    if input.ndim > 2:
        orig_shape = label.shape
        input = torch.movedim(input, 1, -1).reshape(-1, input.shape[1])
        label = label.reshape(-1)
    loss, _ = _hard_nll(input, label, 1, ignore_index)
    if weight is not None:
        w = _take(weight, label).to(loss.dtype)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / w.sum()
    if orig_shape is not None and reduction == "none":
        loss = loss.reshape(orig_shape)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    loss = -(label * torch.log(torch.clamp(input, min=1e-12))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=1e-12)))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def _softplus_neg_abs(x):
    return torch.log1p(torch.exp(-torch.abs(x)))


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    x, y = logit, label
    if pos_weight is not None:
        loss = (1 - y) * x + (1 + (pos_weight - 1) * y) * (
            _softplus_neg_abs(x) + torch.clamp(-x, min=0))
    else:
        loss = torch.clamp(x, min=0) - x * y + _softplus_neg_abs(x)
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / float(input.shape[0])
    return _reduce_loss(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = input - label
    loss = torch.where(torch.abs(d) < delta, 0.5 * d ** 2 / delta,
                       torch.abs(d) - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce_loss(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    x, y = logit, label
    p = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * y + _softplus_neg_abs(x)
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ce * torch.pow(1 - p_t, gamma)
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1.0, input,
                       torch.clamp(float(margin) - input, min=0.0))
    return _reduce_loss(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    sim = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1.0, 1.0 - sim,
                       torch.clamp(sim - float(margin), min=0.0))
    return _reduce_loss(loss, reduction)


def _p_norm(x, p):
    """The reference's ``p_norm`` over the last axis."""
    if p == float("inf"):
        return torch.abs(x).amax(-1)
    if p == float("-inf"):
        return torch.abs(x).amin(-1)
    if p == 0:
        return (x != 0).to(x.dtype).sum(-1)
    if p == 2:
        return torch.sqrt((x * x).sum(-1))
    return torch.pow(torch.pow(torch.abs(x), p).sum(-1), 1.0 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """As in the reference, ``epsilon`` is accepted and not used."""
    p = float(p)
    d_pos = _p_norm(input - positive, p)
    d_neg = _p_norm(input - negative, p)
    if swap:
        d_neg = torch.minimum(d_neg, _p_norm(positive - negative, p))
    loss = torch.clamp(d_pos - d_neg + float(margin), min=0.0)
    return _reduce_loss(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce_loss(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    logsig = torch.nn.functional.logsigmoid
    loss = -(label * logsig(input) + (1 - label) * logsig(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss.mean(-1), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    batch = anchor.shape[0]
    sim = anchor @ positive.t()
    labels = labels.reshape(batch)
    target = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    target = target / target.sum(1, keepdim=True)
    ce = cross_entropy(sim, target, soft_label=True, reduction="mean")
    reg = (torch.square(anchor).sum() + torch.square(positive).sum()) * (
        l2_reg / batch)
    return ce + reg
