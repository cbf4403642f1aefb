"""The rest of the losses: ``ctc_loss``, ``rnnt_loss``, ``hsigmoid_loss``,
``poisson_nll_loss``, ``gaussian_nll_loss``, ``multi_margin_loss``,
``triplet_margin_with_distance_loss``, ``dice_loss``,
``pairwise_distance``, ``margin_cross_entropy``, ``class_center_sample``,
``adaptive_log_softmax_with_loss`` and ``sequence_mask``.

Counterpart of ``paddle_tpu/nn/functional/extra_loss.py``. The reference
composes them in XLA, so here they are plain torch with its arithmetic:

- ``ctc_loss`` takes unnormalised logits ``[T, B, C]`` and applies
  ``log_softmax`` itself. Its forward is the log-space alpha recursion of
  the reference's ``_ctc_nll`` (one step a time step on the device, each
  sequence frozen past its input length); autograd through it gives the
  beta pass. The per-step emissions are read through ``_Embedding``
  (the classes as rows), so their gradient is a deterministic row sum,
  not a scatter-add over the repeated blank. ``norm_by_times`` divides
  only the gradient by each input length; ``"mean"`` divides each
  sample's loss by ``max(label_length, 1)`` before the mean.
- ``rnnt_loss``: the transducer's alpha lattice, one time step after the
  other; along the labels each row is a prefix sum and a
  ``logcumsumexp`` (``alpha[t, u] = E[u] + logsumexp_{k <= u}(from_blank[k]
  - E[k])``, ``E`` the running sum of emissions), the reference's inner
  scan in closed form. ``fastemit_lambda`` adds ``lambda`` times a second
  lattice whose blank arcs carry no gradient, minus its value: the loss
  is unchanged, the emission gradients scaled by ``1 + lambda``.
- ``hsigmoid_loss``: the default complete binary tree walked from each
  label's leaf, or a custom ``path_table`` / ``path_code``; the node
  weights are read through ``_Embedding`` (deterministic gradient).
- ``margin_cross_entropy`` and ``class_center_sample`` accept ``group``
  and ignore it, as the reference (single rank). ``class_center_sample``
  draws its negatives with ``torch.randperm`` from ``generator=``.
- ``sequence_mask`` with ``maxlen=None`` reads the longest length on the
  host, as the reference does.
"""
from __future__ import annotations

import math

import torch

from ...core.generator import use_generator
from .common import _Embedding

__all__ = [
    "ctc_loss", "rnnt_loss", "hsigmoid_loss", "poisson_nll_loss",
    "gaussian_nll_loss", "multi_margin_loss",
    "triplet_margin_with_distance_loss", "dice_loss", "pairwise_distance",
    "margin_cross_entropy", "class_center_sample",
    "adaptive_log_softmax_with_loss", "sequence_mask",
]

_NEG_INF = -1e30


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _shift(a, k):
    """``a`` [B, S] moved right by ``k`` along S, ``_NEG_INF`` in front."""
    return torch.nn.functional.pad(a, (k, 0), value=_NEG_INF)[:, :a.shape[1]]


def _ctc_nll(logits, labels, input_lengths, label_lengths, blank):
    t_len, b, c = logits.shape
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    s = 2 * labels.shape[1] + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    lab_len = label_lengths.long()
    in_len = input_lengths.long()
    ext_valid = (torch.arange(s, device=dev)[None, :]
                 < (2 * lab_len[:, None] + 1))
    prev2 = torch.nn.functional.pad(ext, (2, 0), value=-1)[:, :s]
    can_skip = (ext != blank) & (ext != prev2)
    # emissions [T, B, S]: the classes as rows of a [B * C, T] table
    table = logp.permute(1, 2, 0).reshape(b * c, t_len)
    ids = (torch.arange(b, device=dev)[:, None] * c + ext).reshape(-1)
    emit = _Embedding.apply(table, ids, None).reshape(b, s, t_len)
    emit = emit.permute(2, 0, 1)
    neg = torch.full((), _NEG_INF, device=dev)
    pos = torch.arange(s, device=dev)[None, :]
    alpha = torch.where((pos < 2) & ext_valid, emit[0], neg)
    for t in range(1, t_len):
        merged = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                                 torch.where(can_skip, _shift(alpha, 2), neg))
        new = torch.where(ext_valid, merged + emit[t], neg)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = 2 * lab_len
    final_blank = alpha.gather(1, last[:, None])[:, 0]
    final_label = alpha.gather(1, (last - 1).clamp_min(0)[:, None])[:, 0]
    final_label = torch.where(lab_len > 0, final_label, neg)
    return -torch.logaddexp(final_blank, final_label)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss of unnormalised logits ``log_probs`` [T, B, C] against
    padded ``labels`` [B, L]; per sample [B] with ``reduction="none"``."""
    nll = _ctc_nll(log_probs, labels, input_lengths, label_lengths,
                   int(blank))
    if norm_by_times:
        scaled = nll / input_lengths.float()
        nll = scaled + (nll - scaled).detach()
    if reduction == "mean":
        return (nll / torch.clamp_min(label_lengths.float(), 1.0)).mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def _rnnt_alpha_nll(blank_lp, emit_lp, input_lengths, label_lengths):
    """Transducer negative log-likelihood [B] from blank [B, T, U + 1] and
    emission [B, T, U] log-probabilities."""
    b, t_len, u1 = blank_lp.shape
    dev = blank_lp.device
    in_len = input_lengths.long()
    lab_len = label_lengths.long()
    # prefix sums of each row's emissions: E[t, u] = sum_{j < u} emit[t, j]
    e = torch.cat([torch.zeros(b, t_len, 1, device=dev),
                   emit_lp.cumsum(dim=2)], dim=2)
    u_ok = torch.arange(u1, device=dev)[None, :] <= lab_len[:, None]
    alpha = torch.where(u_ok, e[:, 0], _NEG_INF)
    for t in range(1, t_len):
        from_blank = alpha + blank_lp[:, t - 1]
        row = e[:, t] + torch.logcumsumexp(from_blank - e[:, t], dim=1)
        alpha = torch.where((t < in_len)[:, None], row, alpha)
    t_last = (in_len - 1).clamp(0, t_len - 1)
    final = alpha.gather(1, lab_len[:, None])[:, 0]
    last_blank = blank_lp[torch.arange(b, device=dev), t_last]
    final_blank = last_blank.gather(1, lab_len[:, None])[:, 0]
    return -(final + final_blank)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss of joint-network logits ``input`` [B, T, U + 1, V]
    against ``label`` [B, U]."""
    t_len = input.shape[1]
    logp = torch.log_softmax(input.float(), dim=-1)
    blank_lp = logp[..., int(blank)]
    lab = label.long()[:, None, :, None].expand(-1, t_len, -1, 1)
    emit_lp = logp[:, :, :-1, :].gather(3, lab)[..., 0]
    nll = _rnnt_alpha_nll(blank_lp, emit_lp, input_lengths, label_lengths)
    lam = float(fastemit_lambda)
    if lam > 0.0:
        nll_emit = _rnnt_alpha_nll(blank_lp.detach(), emit_lp, input_lengths,
                                   label_lengths)
        nll = nll + lam * nll_emit - (lam * nll_emit).detach()
    return _reduce(nll, reduction)


def _rows(weight, ids):
    """``weight[ids]`` with a deterministic gradient (``_Embedding``)."""
    return _Embedding.apply(weight, ids.long(), None)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss [N, 1] in fp32: the sum of the sigmoid
    cross-entropies of the branches on each label's path. Default: the
    complete binary tree over ``num_classes`` (internal nodes ``0 ..
    num_classes - 2``, class ``c``'s leaf at heap node ``c + num_classes
    - 1``, the right child the positive branch). Custom: ``path_table``
    [N, L] (node rows, negative = padding) and ``path_code`` [N, L] (the
    0 / 1 branches), both needed."""
    x = input.float()
    w = weight.float()
    rows = w.shape[0]
    if path_table is not None or path_code is not None:
        if path_table is None or path_code is None:
            raise ValueError(
                "custom-tree hsigmoid needs BOTH path_table and path_code")
        pt = path_table.long()
        valid = (pt >= 0).float()
        idx = pt.clamp(0, rows - 1)
        logit = torch.einsum("nd,nld->nl", x,
                             _rows(w, idx.reshape(-1)).reshape(
                                 *idx.shape, -1))
        if bias is not None:
            logit = logit + _rows(bias.float().reshape(-1, 1),
                                  idx.reshape(-1)).reshape(idx.shape)
        ll = torch.logaddexp(logit, torch.zeros_like(logit)) \
            - path_code.float() * logit
        return (ll * valid).sum(dim=-1, keepdim=True)
    n_cls = int(num_classes)
    depth = int(math.ceil(math.log2(max(n_cls, 2))))
    node = label.reshape(-1).long() + n_cls - 1
    total = torch.zeros(x.shape[0], device=x.device)
    for _ in range(depth):
        parent = torch.div(node - 1, 2, rounding_mode="floor")
        is_right = (node % 2 == 0).float()
        valid = (node > 0).float()
        idx = parent.clamp(0, rows - 1)
        logit = (x * _rows(w, idx)).sum(dim=-1)
        if bias is not None:
            logit = logit + _rows(bias.float().reshape(-1, 1), idx)[:, 0]
        ll = torch.logaddexp(logit, torch.zeros_like(logit)) \
            - is_right * logit
        total = total + ll * valid
        node = parent
    return total[:, None]


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    """Poisson negative log-likelihood, with the Stirling term where
    ``full`` and the label is above 1."""
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        t = torch.clamp_min(label, 1.0)
        stirling = label * torch.log(t) - label + 0.5 * torch.log(
            2 * math.pi * t)
        loss = loss + torch.where(label > 1, stirling, 0.0).to(loss.dtype)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """``0.5 * (log(var) + (label - input)^2 / var)`` with ``var`` at least
    ``epsilon`` (plus ``0.5 log(2 pi)`` where ``full``)."""
    var = torch.maximum(variance, torch.full_like(variance, epsilon))
    loss = 0.5 * (torch.log(var) + (label - input) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """``sum_{j != y} max(0, margin - x_y + x_j)^p / C`` per row (fp32),
    each row scaled by ``weight[y]``."""
    x = input.float()
    lab = label.reshape(-1).long()
    n, c = x.shape
    x_y = x.gather(1, lab[:, None])
    margins = torch.clamp_min(margin - x_y + x, 0.0) ** p
    if weight is not None:
        margins = margins * _rows(weight.float().reshape(-1, 1), lab)
    not_y = torch.arange(c, device=x.device)[None, :] != lab[:, None]
    loss = torch.where(not_y, margins, 0.0).sum(dim=1) / c
    return _reduce(loss, reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The ``p``-norm of ``x - y + epsilon`` along the last axis."""
    return torch.linalg.vector_norm(x - y + epsilon, ord=float(p), dim=-1,
                                    keepdim=bool(keepdim))


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``max(d(a, p) - d(a, n) + margin, 0)``, ``d`` defaulting to
    ``pairwise_distance``; ``swap`` takes the smaller of ``d(a, n)`` and
    ``d(p, n)``."""
    if distance_function is None:
        distance_function = pairwise_distance
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, distance_function(positive, negative))
    loss = torch.clamp_min(d_pos - d_neg + float(margin), 0.0)
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - 2 |X n Y| / (|X| + |Y| + epsilon)`` per sample, averaged:
    ``input`` [..., C] probabilities, ``label`` [..., 1] class ids."""
    onehot = torch.nn.functional.one_hot(label.squeeze(-1).long(),
                                         input.shape[-1]).to(input.dtype)
    dims = list(range(1, input.ndim))
    inse = (input * onehot).sum(dim=dims)
    den = input.sum(dim=dims) + onehot.sum(dim=dims)
    return (1 - inse * 2 / (den + epsilon)).mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax in fp32: the target logit (a cosine)
    becomes ``cos(margin1 * theta + margin2) - margin3``, every logit is
    scaled by ``scale``, then cross-entropy. Returns the loss (and the
    softmax of the scaled logits)."""
    x = logits.float()
    lab = label.reshape(-1).long()
    theta = torch.arccos(torch.clamp(x.gather(1, lab[:, None]),
                                     -1.0 + 1e-7, 1.0 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    is_y = torch.arange(x.shape[1], device=x.device)[None, :] == lab[:, None]
    logits_m = torch.where(is_y, target, x) * scale
    nll = -torch.log_softmax(logits_m, dim=-1).gather(1, lab[:, None])
    loss = _reduce(nll, reduction)
    if return_softmax:
        return loss, torch.softmax(logits_m, dim=-1)
    return loss


def class_center_sample(label, num_classes, num_samples, group=None,
                        generator=None):
    """Every positive class of ``label`` plus negatives drawn uniformly
    (``torch.randperm`` from ``generator``, needed when negatives are
    drawn) up to ``num_samples``, sorted. Returns ``(remapped label,
    sampled classes)``: each label's position among the sampled."""
    lab = label.reshape(-1).long()
    dev = lab.device
    pos = torch.unique(lab)
    if pos.numel() >= num_samples:
        sampled = pos
    else:
        if generator is None:
            raise ValueError("class_center_sample draws negative classes: "
                             "pass generator= (a torch.Generator on the "
                             "label's device)")
        is_pos = torch.zeros(num_classes, dtype=torch.bool, device=dev)
        is_pos[pos] = True
        rest = torch.arange(num_classes, device=dev)[~is_pos]
        perm = torch.randperm(rest.numel(), generator=use_generator(
            generator), device=dev)
        extra = rest[perm[:num_samples - pos.numel()]]
        sampled = torch.sort(torch.cat([pos, extra])).values
    remap = torch.full((num_classes,), -1, dtype=torch.long, device=dev)
    remap[sampled] = torch.arange(sampled.numel(), device=dev)
    return remap[lab], sampled


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax over frequency-sorted clusters, in fp32: the head
    ``[in, shortlist + clusters]`` (paddle's layout), each cluster's pair
    ``(w_down [in, h], w_out [h, size])``. Returns (each sample's log
    probability of its label [N], the mean negative log-likelihood)."""
    x = input.float()
    lab = label.reshape(-1).long()
    cutoffs = [int(c) for c in cutoffs]
    shortlist = cutoffs[0]
    head = x @ head_weight.float()
    if head_bias is not None:
        head = head + head_bias.float()
    head_logp = torch.log_softmax(head, dim=-1)
    short = lab.clamp(0, shortlist - 1)
    out = torch.where(lab < shortlist,
                      head_logp.gather(1, short[:, None])[:, 0], 0.0)
    low = shortlist
    for i, (w_down, w_out) in enumerate(tail_weights):
        high = cutoffs[i + 1] if i + 1 < len(cutoffs) else cutoffs[-1]
        tail = torch.log_softmax((x @ w_down.float()) @ w_out.float(),
                                 dim=-1)
        idx = (lab - low).clamp(0, tail.shape[1] - 1)
        lp = head_logp[:, shortlist + i] + tail.gather(1, idx[:, None])[:, 0]
        out = torch.where((lab >= low) & (lab < high), lp, out)
        low = high
    return out, -out.mean()


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` with ``maxlen`` columns (the longest
    length where ``None``), in ``dtype``."""
    if maxlen is None:
        maxlen = int(x.max())
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    mask = torch.arange(int(maxlen), device=x.device) < x[..., None]
    return mask.to(dtype)
