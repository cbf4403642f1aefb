"""Tensor-parallel (Megatron) layers: ``VocabParallelEmbedding``,
``ColumnParallelLinear``, ``RowParallelLinear``,
``ParallelCrossEntropy`` and the mp ops ``_c_identity``, ``_c_concat``,
``_c_split``, ``_mp_allreduce``.

Counterpart of ``paddle_tpu/distributed/fleet/mp_layers.py`` (Paddle's
``fleet/layers/mpu/mp_layers.py`` and ``mp_ops.py``). The reference lays
each weight out on the mesh's ``mp`` axis and lets GSPMD insert the
collectives; here each rank holds its shard (a ``DistParameter``, whose
``full_tensor()`` is the whole weight) and computes on local tensors with
Megatron's explicit collectives (``communication/functional.py``):

- ``ColumnParallelLinear``: the input enters through ``_c_identity``
  (identity forward, all-reduce backward), the rank's output columns
  come out; ``gather_output`` all-gathers them.
- ``RowParallelLinear``: the rank's input columns (``_c_split`` of a
  whole input unless ``input_is_parallel``) times its weight columns, an
  all-reduce, then the bias, once.
- ``VocabParallelEmbedding``: ids outside the rank's vocabulary range
  read row 0 and are zeroed, then an all-reduce. The backward is the
  port's deterministic row sum (``nn.functional.common._Embedding``) on
  the local shard: no scatter-add.
- ``ParallelCrossEntropy`` over vocab-sharded logits: each rank's max
  and sum of exponents all-reduced over mp, the label's logit from the
  rank that owns it; ``[N, 1]`` per token as Paddle's.

Weights are torch's ``[out, in]``, where the reference's are ``[in,
out]``: its ``Shard(1)`` on a column-parallel weight is ``Shard(0)``
here, its ``Shard(0)`` on a row-parallel weight ``Shard(1)``. Without
``fleet.init`` (or an ``mp_group``) a layer is unsharded and its
collectives are the identity; with a group of one rank each layer
computes what ``torch.nn.Linear`` / the port's ``Embedding`` compute,
the same ops. The ``from_*`` constructors wrap an existing layer's
parameters (the models' shard plans use them).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.common import _Embedding
from ..auto_parallel.api import _shard_param_
from ..auto_parallel.placement import Replicate, Shard, to_torch_placements
from ..communication import functional as cf
from .topology import get_hybrid_communicate_group

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "column_projections",
           "vocab_parallel_cross_entropy",
           "vocab_parallel_fused_linear_cross_entropy"]


def _mp_group(mp_group=None):
    if mp_group is not None:
        return mp_group
    hcg = get_hybrid_communicate_group()
    return None if hcg is None else hcg.get_model_parallel_group()


def _degree(group) -> int:
    return 1 if group is None else group.nranks


def _rank(group) -> int:
    return 0 if group is None else group.rank


def mp_shard_(p, group, dim=None, split_factor=1):
    """Lay parameter ``p`` out over ``group``'s mesh: ``Shard(dim)`` on its
    axis (``dim`` None: replicated). ``split_factor`` > 1 views ``dim`` as
    that many equal parts and shards each (torch's ``_StridedShard``), so
    a fused ``[q | k | v]`` weight gives each rank its heads of all
    three."""
    mesh = getattr(group, "mesh", None)
    if mesh is None:
        raise ValueError(
            "tensor-parallel layers need a mesh axis group as mp_group "
            "(fleet.init's, or communication.group.axis_group)")
    axis = mesh.dim_names.index(group.axis_name)
    placements = [Replicate() for _ in range(mesh.ndim)]
    tpl = None
    if dim is not None:
        if p.shape[dim] % (group.nranks * split_factor):
            raise ValueError(
                f"dim {dim} ({p.shape[dim]}) of a {tuple(p.shape)} "
                f"parameter does not split over {group.nranks} mp ranks"
                + (f" x {split_factor} parts" if split_factor > 1 else ""))
        placements[axis] = Shard(dim)
        if split_factor > 1:
            from torch.distributed.tensor.placement_types import \
                _StridedShard

            tpl = to_torch_placements(placements)
            tpl[axis] = _StridedShard(dim, split_factor=split_factor)
    return _shard_param_(p, mesh, placements, tpl)


def _init_weight(shape, weight_attr, device, dtype):
    w = torch.empty(shape, device=device, dtype=dtype)
    if callable(weight_attr):
        weight_attr(w)
    else:
        nn.init.xavier_normal_(w)
    return nn.Parameter(w)


class VocabParallelEmbedding(nn.Module):
    """An embedding whose rows (the vocabulary) are sharded over mp
    (module docstring). ``weight_attr`` may be an initializer called on
    the whole weight (default Xavier normal, as the reference's)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = None
        self.weight = _init_weight([num_embeddings, embedding_dim],
                                   weight_attr, device, dtype)
        self._setup(_mp_group(mp_group))

    def _setup(self, group):
        self.mp_group = group
        n = _degree(group)
        if group is not None:
            mp_shard_(self.weight, group, 0)
        self.vocab_start = _rank(group) * (self.num_embeddings // n)
        self.vocab_end = self.vocab_start + self.num_embeddings // n

    @classmethod
    def from_embedding(cls, emb, group):
        """Shard an existing embedding's weight (the same parameter)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.num_embeddings, self.embedding_dim = emb.weight.shape
        self.padding_idx = getattr(emb, "padding_idx", None)
        if self.padding_idx is not None and _degree(group) > 1:
            raise ValueError("VocabParallelEmbedding: padding_idx over more "
                             "than one mp rank")
        self.weight = emb.weight
        self._setup(group)
        return self

    def forward(self, x):
        """As the port's ``Embedding`` (ids are not read on the host)."""
        if _degree(self.mp_group) == 1:
            return _Embedding.apply(self.weight, x.long(), self.padding_idx)
        ids = x.long()
        outside = (ids < self.vocab_start) | (ids >= self.vocab_end)
        local = (ids - self.vocab_start).masked_fill(outside, 0)
        out = _Embedding.apply(self.weight, local, None)
        out = out.masked_fill(outside[..., None], 0)
        return cf.reduce_fwd(out, self.mp_group)


class ColumnParallelLinear(nn.Module):
    """A linear layer whose output features are sharded over mp (module
    docstring); ``gather_output`` all-gathers the output."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = _init_weight([out_features, in_features], weight_attr,
                                   device, dtype)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias in (None, True) else None)
        self._setup(_mp_group(mp_group), 1)

    def _setup(self, group, split_factor):
        self.mp_group = group
        if group is not None:
            mp_shard_(self.weight, group, 0, split_factor)
            if self.bias is not None:
                mp_shard_(self.bias, group, 0, split_factor)

    @classmethod
    def from_linear(cls, linear, group, gather_output=False,
                    split_factor=1):
        """Shard an existing ``nn.Linear``'s parameters (the same
        objects); ``split_factor`` as in :func:`mp_shard_`."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.out_features, self.in_features = linear.weight.shape
        self.gather_output = gather_output
        self.weight = linear.weight
        self.bias = linear.bias
        self._setup(group, split_factor)
        return self

    def enter(self, x):
        """The input as this layer takes it: identity forward, all-reduce
        of its gradient over mp."""
        return cf.reduce_bwd(x, self.mp_group)

    def project(self, x):
        """The layer on an input that has already entered (``enter``):
        layers sharing one input enter it once, so its gradient is
        all-reduced once."""
        out = torch.nn.functional.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = cf.gather(out, self.mp_group, -1)
        return out

    def forward(self, x):
        return self.project(self.enter(x))


def column_projections(x, layers):
    """``[layer(x) for layer in layers]`` for layers that share the input
    ``x``; column-parallel layers take it through one ``enter``, so its
    gradient is all-reduced once for all of them (q, k and v; gate and
    up)."""
    enter = getattr(layers[0], "enter", None)
    if enter is None:
        return [layer(x) for layer in layers]
    x = enter(x)
    return [layer.project(x) for layer in layers]


class RowParallelLinear(nn.Module):
    """A linear layer whose input features are sharded over mp (module
    docstring); the bias is replicated and added once, after the
    all-reduce."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = _init_weight([out_features, in_features], weight_attr,
                                   device, dtype)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)
        self._setup(_mp_group(mp_group))

    def _setup(self, group):
        self.mp_group = group
        if group is not None:
            mp_shard_(self.weight, group, 1)
            if self.bias is not None:
                mp_shard_(self.bias, group, None)

    @classmethod
    def from_linear(cls, linear, group, input_is_parallel=True):
        """Shard an existing ``nn.Linear``'s parameters (the same
        objects)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.out_features, self.in_features = linear.weight.shape
        self.input_is_parallel = input_is_parallel
        self.weight = linear.weight
        self.bias = linear.bias
        self._setup(group)
        return self

    def forward(self, x):
        if _degree(self.mp_group) == 1:
            return torch.nn.functional.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = cf.split(x, self.mp_group, -1)
        out = cf.reduce_fwd(torch.nn.functional.linear(x, self.weight),
                            self.mp_group)
        return out if self.bias is None else out + self.bias


def vocab_parallel_cross_entropy(logits, label, group, ignore_index=-100):
    """Per-token softmax cross-entropy of logits sharded over ``group``
    on their last dim (this rank's columns ``[rank * V/n, (rank + 1) *
    V/n)``), computed in fp32 and returned in the logits' dtype; an
    ``ignore_index`` label gives 0. With one rank it is
    ``nn.functional.cross_entropy(..., reduction="none")``."""
    from ...nn import functional as F

    if _degree(group) == 1:
        return F.cross_entropy(logits, label, ignore_index=ignore_index,
                               reduction="none")
    x = logits.float()
    vl = x.shape[-1]
    m = x.detach().amax(dim=-1, keepdim=True)
    torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX,
                                 group=group.process_group)
    s = cf.reduce_fwd((x - m).exp().sum(dim=-1), group)
    lse = s.log() + m.squeeze(-1)
    label = label.long()
    local = label - _rank(group) * vl
    owned = (local >= 0) & (local < vl)
    ll = x.gather(-1, local.clamp(0, vl - 1)[..., None]).squeeze(-1)
    ll = cf.reduce_fwd(torch.where(owned, ll, torch.zeros_like(ll)), group)
    loss = torch.where(label == ignore_index, torch.zeros_like(lse),
                       lse - ll)
    return loss.to(logits.dtype)


def global_numel(p) -> int:
    """A parameter's element count; a sharded one's whole tensor's."""
    shape = getattr(p, "global_shape", None)
    return p.numel() if shape is None else shape.numel()


def check_divides(what, sizes, mp):
    """Raise ``ValueError`` unless ``mp`` divides every named size (a
    shard plan's check of its model's widths)."""
    for name, size in sizes.items():
        if size % mp:
            raise ValueError(
                f"{what}: {name} = {size} does not divide over mp = {mp}")


def lm_cross_entropy(logits, labels, group):
    """The mean token cross-entropy of ``logits`` (vocab-sharded over
    ``group`` unless it is None) against ``labels`` (``-100`` ignored):
    a language model's unfused loss."""
    from ...nn import functional as F

    v = logits.shape[-1]
    if group is None or group.nranks == 1:
        return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                               ignore_index=-100)
    labels = labels.reshape(-1)
    per = vocab_parallel_cross_entropy(logits.reshape(-1, v), labels, group)
    count = (labels != -100).sum().clamp(min=1)
    return per.sum() / count.to(per.dtype)


def vocab_parallel_fused_linear_cross_entropy(hidden, weight, labels, group,
                                              ignore_index=-100,
                                              chunk_size=2048):
    """``incubate.nn.functional.fused_linear_cross_entropy`` with the
    lm-head weight ``[V/n, H]`` sharded over ``group`` by vocabulary rows
    (Megatron's vocab-parallel cross-entropy, chunked over tokens as the
    fused op is): ``hidden`` [T, H] whole on every rank, the mean over
    the non-ignored tokens. With one rank it is the fused op itself."""
    from torch.utils.checkpoint import checkpoint

    from ...incubate.nn.functional import fused_linear_cross_entropy

    if _degree(group) == 1:
        return fused_linear_cross_entropy(hidden, weight, labels,
                                          ignore_index=ignore_index,
                                          chunk_size=chunk_size)

    def chunk_loss(h_c, w, l_c):
        logits = torch.matmul(h_c, w.t())
        per = vocab_parallel_cross_entropy(logits, l_c, group, ignore_index)
        return per.float().sum()

    hidden = cf.reduce_bwd(hidden, group)
    labels = labels.long()
    count = (labels != ignore_index).sum()
    with torch.autocast(hidden.device.type, enabled=False):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for start in range(0, hidden.shape[0], int(chunk_size)):
            sl = slice(start, start + int(chunk_size))
            total = total + checkpoint(chunk_loss, hidden[sl], weight,
                                       labels[sl], use_reentrant=False)
    return total / count.clamp(min=1).to(torch.float32)


class ParallelCrossEntropy(nn.Module):
    """Cross-entropy over vocab-sharded logits, ``[N, 1]`` per token
    (module docstring)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.ndim == input.ndim and label.shape[-1] == 1:
            label = label.squeeze(-1)
        return vocab_parallel_cross_entropy(
            input, label, self.mp_group, self.ignore_index).unsqueeze(-1)


# mp ops (Paddle's mpu/mp_ops.py)
def _c_identity(tensor, group=None):
    """Identity forward, all-reduce of the gradient over mp."""
    return cf.reduce_bwd(tensor, _mp_group(group))


def _c_concat(tensor, group=None):
    """All-gather along the last dim; the gradient's chunk back."""
    return cf.gather(tensor, _mp_group(group), -1)


def _c_split(tensor, group=None):
    """This rank's chunk of the last dim; the gradient all-gathered."""
    return cf.split(tensor, _mp_group(group), -1)


def _mp_allreduce(tensor, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    """All-reduce over mp; the gradient passes as it is."""
    return cf.reduce_fwd(tensor, _mp_group(group))
