"""Fused linear + softmax cross-entropy, chunked over tokens.

Counterpart of ``paddle_tpu/incubate/nn/functional/fused_linear_ce.py``.
A Llama-class lm head would otherwise hold fp32 logits [T, V] and their
gradient (4 GB at 8k tokens and a 32k vocabulary). The tokens are cut
into chunks; each chunk's logits, log-sum-exp and label log-probability
are computed inside ``torch.utils.checkpoint``, so the backward replays
one [chunk, V] block at a time. The last chunk is padded with
``ignore_index``. The logits product is a plain matmul outside any
kernel in the reference too, so it stays ``torch.matmul``: it runs in
the inputs' dtype (cuBLAS accumulates in fp32) and is rounded once to
that dtype before the softmax math, which is fp32. The reference's
product returns fp32 directly, so in bf16 the two differ by that one
rounding of the logits; in fp32 they compute the same thing.

The weight is the port's lm-head layout ``[V, H]`` (torch's Linear),
where the reference's is ``[H, V]``. Under autocast it runs in its
inputs' dtypes, autocast off: the reference's op is not on amp's white
list, so an fp32 model's lm head stays fp32 under O1 in both packages.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["fused_linear_cross_entropy"]


def _chunk_loss(h_c, weight, l_c, ignore_index):
    logits = torch.matmul(h_c, weight.t()).float()           # [C, V]
    lse = torch.logsumexp(logits, dim=-1)
    valid = l_c != ignore_index
    safe = l_c.clamp(0, logits.shape[-1] - 1)
    ll = logits.gather(1, safe[:, None])[:, 0]
    loss_sum = torch.where(valid, lse - ll, torch.zeros_like(lse)).sum()
    return loss_sum, valid.sum()


def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               chunk_size=2048):
    """Mean token cross-entropy of softmax(hidden @ weight.T) without the
    full logits tensor. hidden: [T, H]; weight: [V, H]; labels: [T] int,
    ``ignore_index`` entries excluded from the mean. Returns an fp32
    scalar, ``sum(lse - ll) / max(count, 1)``."""
    t = hidden.shape[0]
    if (hidden.ndim != 2 or weight.ndim != 2
            or weight.shape[1] != hidden.shape[1]):
        raise ValueError(
            f"fused_linear_cross_entropy: hidden [T, H] and weight [V, H] "
            f"expected, got {tuple(hidden.shape)} and {tuple(weight.shape)}")
    if labels.shape != (t,):
        raise ValueError(f"fused_linear_cross_entropy: labels must be [{t}], "
                         f"got {tuple(labels.shape)}")
    with torch.autocast(hidden.device.type, enabled=False):
        return _chunked_loss(hidden, weight, labels, ignore_index,
                             int(chunk_size))


def _chunked_loss(hidden, weight, labels, ignore_index, chunk):
    t = hidden.shape[0]
    n_chunks = max(1, -(-t // chunk))
    pad = n_chunks * chunk - t
    labels = labels.long()
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=ignore_index)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        ls, c = checkpoint(_chunk_loss, hidden[sl], weight, labels[sl],
                           ignore_index, use_reentrant=False)
        loss_sum = loss_sum + ls
        count = count + c
    return loss_sum / count.clamp(min=1).to(torch.float32)
