"""Structured attention-bias descriptors for
``memory_efficient_attention``.

Counterpart of ``paddle_tpu/incubate/nn/attn_bias.py`` (the xformers-style
``AttentionBias`` family), with its classes and methods. ``materialize``
builds the additive mask (0 where a query may see a key, ``-inf``
elsewhere) as a torch tensor of the given shape and dtype on an explicit
``device``: ``None`` is the card, and raises without one; the CPU is
``device="cpu"``. The sequence-length bookkeeping (``seqstart``,
``seqlen``) is host metadata, kept as int32 CPU tensors beside their
Python lists.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ...core.place import resolve_device

__all__ = [
    "AttentionBias", "LowerTriangularMask", "LowerTriangularMaskWithTensorBias",
    "SeqLenInfo", "PaddedSeqLenInfo", "BlockDiagonalMask",
    "BlockDiagonalCausalMask",
]

_NEG_INF = float("-inf")


def _require(ok, what):
    """Raise ``ValueError`` naming ``what`` unless ``ok`` (the reference
    asserts these)."""
    if not ok:
        raise ValueError(what)


def _torch_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class AttentionBias(ABC):
    @abstractmethod
    def materialize(self, shape, dtype="float32", device=None):
        raise NotImplementedError  # abstract


class LowerTriangularMask(AttentionBias):
    """Causal, top-left aligned: query i sees keys 0..i."""

    def materialize(self, shape, dtype="float32", device=None):
        full = torch.full(tuple(shape), _NEG_INF, dtype=torch.float32,
                          device=resolve_device(device))
        return torch.triu(full, diagonal=1).to(_torch_dtype(dtype))

    def add_bias(self, bias):
        return LowerTriangularMaskWithTensorBias(bias)


class LowerTriangularMaskWithTensorBias(LowerTriangularMask):
    """The causal mask plus an additive ``bias`` tensor."""

    def __init__(self, bias):
        self._bias = bias

    def materialize(self, shape, dtype="float32", device=None):
        base = super().materialize(shape, dtype, device)
        return base + self._bias.to(base.device)


@dataclass
class SeqLenInfo:
    seqstart: torch.Tensor
    max_seqlen: int
    seqstart_py: List[int]

    def intervals(self):
        yield from zip(self.seqstart_py, self.seqstart_py[1:])

    @classmethod
    def from_seqlens(cls, seqlens):
        seqstart_py = [0]
        max_seqlen = -1
        for seqlen in seqlens:
            max_seqlen = max(max_seqlen, seqlen)
            seqstart_py.append(seqstart_py[-1] + seqlen)
        return cls(max_seqlen=max_seqlen,
                   seqstart=torch.tensor(seqstart_py, dtype=torch.int32),
                   seqstart_py=seqstart_py)

    def split(self, x, batch_sizes=None):
        """``x`` ``[1, total, ...]`` cut at the sequence starts into
        ``[batch_size, len, ...]`` pieces (one sequence a piece by
        default)."""
        _require(self.seqstart_py[-1] == x.shape[1] and x.shape[0] == 1,
                 f"split: x {tuple(x.shape)} is not [1, "
                 f"{self.seqstart_py[-1]}, ...]")
        if batch_sizes is None:
            batch_sizes = [1] * (len(self.seqstart_py) - 1)
        out, it = [], 0
        for bs in batch_sizes:
            start, end = self.seqstart_py[it], self.seqstart_py[it + bs]
            out.append(x[:, start:end].reshape((bs, -1) + tuple(x.shape[2:])))
            it += bs
        return out


@dataclass
class PaddedSeqLenInfo(SeqLenInfo):
    seqlen: torch.Tensor = None
    seqlen_py: Sequence[int] = ()

    def intervals(self):
        for (start, _), length in zip(
                zip(self.seqstart_py, self.seqstart_py[1:]), self.seqlen_py):
            yield start, start + length

    @classmethod
    def from_seqlens(cls, seqlens):
        raise NotImplementedError(
            "Use SeqLenInfo.from_seqlens() or "
            "PaddedSeqLenInfo.from_seqlens_padded().")

    @classmethod
    def from_seqlens_padded(cls, seqlens, padding):
        _require(all(s <= padding for s in seqlens),
                 f"a sequence length of {list(seqlens)} exceeds the padding "
                 f"{padding}")
        seqstart_py = list(range(0, len(seqlens) * padding + 1, padding))
        return cls(seqlen=torch.tensor(list(seqlens), dtype=torch.int32),
                   seqlen_py=list(seqlens), max_seqlen=max(seqlens),
                   seqstart=torch.tensor(seqstart_py, dtype=torch.int32),
                   seqstart_py=seqstart_py)

    def split(self, x, batch_sizes=None):
        raise NotImplementedError(
            "PaddedSeqLenInfo.split: padded-interleaved splitting is not "
            "used by the attention path")


@dataclass
class BlockDiagonalMask(AttentionBias):
    """Each query sequence sees only its own key sequence (sequences packed
    along one axis)."""

    q_seqinfo: SeqLenInfo
    k_seqinfo: SeqLenInfo
    _batch_sizes: Optional[Sequence[int]] = None

    def _block(self, q_len, k_len, device):
        return torch.zeros(q_len, k_len, dtype=torch.float32, device=device)

    def materialize(self, shape, dtype="float32", device=None):
        dev = resolve_device(device)
        _require(shape[-1] == self.k_seqinfo.seqstart_py[-1]
                 and shape[-2] == self.q_seqinfo.seqstart_py[-1],
                 f"materialize: shape {tuple(shape)} does not end in "
                 f"[{self.q_seqinfo.seqstart_py[-1]}, "
                 f"{self.k_seqinfo.seqstart_py[-1]}]")
        mask = torch.full(tuple(shape[-2:]), _NEG_INF, dtype=torch.float32,
                          device=dev)
        for (qs, qe), (ks, ke) in zip(self.q_seqinfo.intervals(),
                                      self.k_seqinfo.intervals()):
            mask[qs:qe, ks:ke] = self._block(qe - qs, ke - ks, dev)
        return mask.expand(tuple(shape)).to(_torch_dtype(dtype))

    @classmethod
    def from_seqlens(cls, q_seqlen, kv_seqlen=None):
        _require(kv_seqlen is None or len(q_seqlen) == len(kv_seqlen),
                 "q_seqlen and kv_seqlen differ in length")
        q_seqinfo = SeqLenInfo.from_seqlens(q_seqlen)
        if kv_seqlen is None or list(q_seqlen) == list(kv_seqlen):
            k_seqinfo = q_seqinfo
        else:
            k_seqinfo = SeqLenInfo.from_seqlens(kv_seqlen)
        return cls(q_seqinfo=q_seqinfo, k_seqinfo=k_seqinfo)

    @classmethod
    def from_tensor_list(cls, tensors):
        """The mask of a list of ``[b, s, ...]`` tensors and their
        concatenation ``[1, sum(b * s), ...]``."""
        batch_sizes = [t.shape[0] for t in tensors]
        seqlens = []
        for x in tensors:
            seqlens.extend([x.shape[1]] * x.shape[0])
        block_diag = cls.from_seqlens(seqlens)
        block_diag._batch_sizes = batch_sizes
        concated = torch.cat(
            [x.reshape((1, -1) + tuple(x.shape[2:])) for x in tensors], dim=1)
        return block_diag, concated

    def make_causal(self):
        return BlockDiagonalCausalMask(
            q_seqinfo=self.q_seqinfo, k_seqinfo=self.k_seqinfo,
            _batch_sizes=self._batch_sizes)

    def split(self, x, batch_sizes=None):
        return self.q_seqinfo.split(x, batch_sizes or self._batch_sizes)


@dataclass
class BlockDiagonalCausalMask(BlockDiagonalMask):
    def _block(self, q_len, k_len, device):
        # top-left aligned, as the reference (triu k=1 whatever k_len is)
        return torch.triu(torch.full((q_len, k_len), _NEG_INF,
                                     dtype=torch.float32, device=device),
                          diagonal=1)
