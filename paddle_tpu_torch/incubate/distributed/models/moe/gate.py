"""MoE gates: top-k softmax routing with a static expert capacity.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe/gate.py``.
A gate scores each token against the experts (``x @ weight + bias``,
softmax), picks its top-k experts, and gives each (token, expert) pair a
position in that expert's buffer of ``capacity`` slots: first come,
first served over the tokens, the second choices queued behind every
first choice. A pair past the capacity is dropped (``_route``).
``forward`` returns the GShard dense tensors, ``combine`` (the mixture
weights, carrying the gradient) and ``dispatch`` (0/1, no gradient),
both ``[N, E, C]``; ``route`` returns what the index path of
``moe_layer.py`` starts from.

Random draws (GShard's random second-expert routing, the switch gate's
jitter) come from the gate's explicit ``generator`` through
``core.generator.use_generator``, so a recompute region and a captured
CUDA graph replay them. They are the port's own stream, not
``jax.random``'s: the routing functions take the uniform draw ``u``
``[N]`` as an input, so a test can give both packages the same one.

Top-k takes ``lax.top_k``'s order (the lower expert first among equal
scores) through ``models.generation._topk``.

Routing over the global batch. The reference routes the whole batch
that GSPMD sees: under data parallelism its capacity counts every
rank's tokens, the slot positions run over all of them (rank 0's first,
as the batch is ``Shard(0)`` on ``dp``) and the balance loss takes its
two means over all of them. A rank of the port sees only its own
tokens, so a gate routes over the ranks of its *batch group*: the
gate's ``group`` where given, else the group of the ``DataParallel``
or ZeRO wrapper (``GroupShardedStage2`` / ``3``) around the model (each
hands it to every gate through :meth:`BaseGate.set_batch_group`), else
none (this rank's tokens alone). Over a group of ``n`` ranks (each with the same number of
tokens, as ``Shard(0)`` of a batch gives) the capacity is that of ``n``
times this rank's tokens; each pass of the k choices all-gathers every
rank's per-expert counts, and this rank's positions start after the
counts of the ranks before it (``_route``); the balance loss's mean of
the probabilities is all-reduced differentiably (``psum``, whose
backward all-reduces, so after ``DataParallel``'s average the gate's
gradient is the reference's) and the top-1 fractions without gradient.
Tokens replicated over an expert-parallel axis share one routing: the
batch group is the data-parallel one, not the expert group.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .....core.generator import make_generator, use_generator
from .....core.place import resolve_device
from .....distributed.communication import functional as cf

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


def _xavier_uniform_(p, generator):
    """paddle's ``XavierUniform`` on ``p``: a 2-D weight is ``[in, out]``,
    a stacked one ``[n, in, out]`` counts ``n`` into both fans."""
    shape = p.shape
    if p.ndim == 2:
        fan_in, fan_out = shape
    else:
        receptive = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    p.uniform_(-limit, limit, generator=generator)


def _one_hot(idx, n, dtype):
    """``[..., n]`` one-hot of integer ``idx`` in ``dtype``; ids outside
    ``[0, n)`` give a zero row (as ``jax.nn.one_hot``), with no host
    read."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk(x, k):
    """(values, indices) of the ``k`` largest entries of each row of
    ``x`` in ``lax.top_k``'s order; the values in ``x``'s dtype (and
    differentiable through the gather)."""
    from .....models.generation import _topk as topk_fp32

    _, idx = topk_fp32(x.float(), k)
    return x.gather(1, idx), idx


def _capacity(num_tokens: int, num_experts: int, k: int,
              factor: float) -> int:
    return max(4, int(math.ceil(k * num_tokens / num_experts * factor)))


def _positions(mask, prior):
    """Each (token, expert) pair's position in the expert's buffer: the
    count of earlier tokens routed to the expert (``mask`` [N, E] 0/1
    integers) plus ``prior`` [E]. The scan runs along the last axis of
    the transposed mask: torch's scan down the N rows of E short columns
    took 1.4 ms a call at 8192 x 8 on the card."""
    return mask.t().contiguous().cumsum(dim=1).t() - mask + prior[None, :]


def _random_second(top_vals, u):
    """GShard's random routing: keep the second expert where ``u <
    2 * top_vals[:, 1]``, else give it weight 0 (it then takes no
    capacity). Returns (top_vals, keep2)."""
    keep2 = u < 2.0 * top_vals[:, 1]
    second = torch.where(keep2, top_vals[:, 1], 0.0)
    return torch.cat([top_vals[:, :1], second[:, None], top_vals[:, 2:]],
                     dim=1), keep2


def _group_counts(counts, group):
    """(the counts of the batch group's ranks before this one, their sum
    over every rank): ``counts`` [E] of each rank all-gathered."""
    pg, n = cf._pg(group)
    every = counts.new_empty(n * counts.numel())
    torch.distributed.all_gather_into_tensor(every, counts.contiguous(),
                                             group=pg)
    every = every.reshape(n, -1)
    return every[:torch.distributed.get_rank(pg)].sum(dim=0), every.sum(dim=0)


def _route(probs, u, *, k, capacity, normalize, random2, group=None):
    """GShard routing, shared by the dense dispatch and the index path's
    forward and backward. ``u`` [N] is random routing's uniform draw (read only with
    ``random2`` and ``k >= 2``). ``group`` is the batch group (module
    docstring): this rank's tokens take their positions after those of
    the group's earlier ranks, pass by pass. Returns (tv, raw_tv, top_idx, keep,
    flat, token_of_slot, j_of_slot, keep2): ``tv`` the (normalized)
    weights of the k choices before the keep mask, ``raw_tv`` before the
    normalization, ``keep`` [N, k] the choices that got a slot, ``flat``
    [N, k] each choice's slot ``expert * C + position`` (the overflow bin
    ``E * C`` where dropped), and the inverse maps over the ``E * C + 1``
    slots: the token of each slot (``N``, the zero row, where empty) and
    its choice index. Every kept choice owns a unique slot, so the
    inverse maps are integer writes; only the overflow bin, sliced off
    by every reader, takes several."""
    n, e = probs.shape
    c = capacity
    top_vals, top_idx = _topk(probs, k)
    keep2 = None
    if random2 and k >= 2:
        top_vals, keep2 = _random_second(top_vals, u)
    raw_tv = top_vals
    tv = (top_vals / torch.clamp(top_vals.sum(dim=1, keepdim=True), min=1e-9)
          if normalize else top_vals)
    prior = torch.zeros(e, dtype=torch.long, device=probs.device)
    many = cf._pg(group)[1] > 1
    slots, keeps = [], []
    for j in range(k):
        live = top_vals[:, j] > 0
        mask = _one_hot(top_idx[:, j], e, torch.long) * live.long()[:, None]
        if many:
            before, total = _group_counts(mask.sum(dim=0), group)
            pos = _positions(mask, prior + before)
            prior = prior + total
        else:
            pos = _positions(mask, prior)
            prior = prior + mask.sum(dim=0)
        pos_j = (pos * mask).sum(dim=1)
        keeps.append((pos_j < c) & live)
        slots.append(pos_j)
    keep = torch.stack(keeps, dim=1)
    flat = torch.where(keep, top_idx * c + torch.stack(slots, dim=1), e * c)
    dev = probs.device
    token_of_slot = torch.full((e * c + 1,), n, dtype=torch.long, device=dev)
    token_of_slot.index_put_(
        (flat.reshape(-1),),
        torch.arange(n, device=dev)[:, None].expand(n, k).reshape(-1))
    j_of_slot = torch.zeros(e * c + 1, dtype=torch.long, device=dev)
    j_of_slot.index_put_(
        (flat.reshape(-1),),
        torch.arange(k, device=dev)[None, :].expand(n, k).reshape(-1))
    return tv, raw_tv, top_idx, keep, flat, token_of_slot, j_of_slot, keep2


def _dispatch_from_probs(probs, u, *, k, capacity, normalize, random2,
                         group=None):
    """``[N, E, C]`` (combine, dispatch) from ``[N, E]`` probs (GShard
    Algorithm 1): each kept choice's weight (combine) and 1 (dispatch)
    at its slot from :func:`_route` (over the batch ``group``)."""
    n, e = probs.shape
    slots = e * capacity
    tv, _, _, keep, flat, _, _, _ = _route(
        probs, u, k=k, capacity=capacity, normalize=normalize,
        random2=random2, group=group)

    def at_slots(vals):
        return probs.new_zeros(n, slots + 1).scatter(1, flat, vals)[
            :, :slots].reshape(n, e, capacity)

    return (at_slots(torch.where(keep, tv, 0.0)),
            at_slots(keep.to(probs.dtype)).detach())


class BaseGate(nn.Module):
    """Holds ``(num_expert, world_size)``, the batch group (module
    docstring) and the aux loss that the trainer reads with ``get_loss``
    (which clears it by default)."""

    def __init__(self, num_expert: int, world_size: int, group=None):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = num_expert * world_size
        self.group = group
        self._wrapper_group = None
        self.loss = None

    def set_batch_group(self, group):
        """The group of the data-parallel wrapper around the model;
        routed over unless the gate has its own ``group``."""
        self._wrapper_group = group

    def batch_group(self):
        """The ranks whose tokens this gate routes as one batch (module
        docstring), or None."""
        group = self.group if self.group is not None else \
            self._wrapper_group
        pg, n = cf._pg(group)
        return group if pg is not None and n > 1 else None

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class NaiveGate(BaseGate):
    """Top-k softmax gate, no balance loss, a generous capacity (twice
    the even share: the reference's naive gate drops nothing).

    Beyond the reference's arguments: ``device`` (``None`` is the card),
    ``dtype``, ``seed`` (the weight's init, paddle's ``XavierUniform``;
    the bias is 0) and ``generator``, the source of the gate's random
    draws (one made from ``seed`` when None)."""

    def __init__(self, d_model, num_expert, world_size, topk=2,
                 capacity_factor=2.0, *, group=None, device=None,
                 dtype=torch.float32, seed=0, generator=None):
        super().__init__(num_expert, world_size, group)
        dev = resolve_device(device)
        self.d_model = d_model
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.weight = nn.Parameter(torch.empty(d_model, self.tot_expert,
                                               device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.tot_expert, device=dev,
                                             dtype=dtype))
        with torch.no_grad():
            _xavier_uniform_(self.weight, make_generator(seed, dev))
        self.generator = (generator if generator is not None
                          else make_generator(seed, dev))
        self._normalize = True
        self._random2 = False
        self._loss_kind = None

    def _train_factor(self):
        return self.capacity_factor

    def _jitter(self, x):
        return x

    def route(self, x):
        """x [N, d_model] -> (probs [N, E], capacity, u): ``u`` is the
        uniform draw [N] of random routing, drawn only where it is read
        (random routing, training, top-k >= 2), else None. Sets the aux
        loss."""
        x = self._jitter(x)
        probs = torch.softmax(torch.matmul(x, self.weight) + self.bias,
                              dim=-1)
        n = x.shape[0]
        group = self.batch_group()
        cap = _capacity(n * cf._pg(group)[1], self.tot_expert, self.topk,
                        self._train_factor())
        u = None
        if self._random2 and self.training and self.topk >= 2:
            u = torch.rand(n, generator=use_generator(self.generator),
                           device=x.device)
        if self._loss_kind is not None:
            self.set_loss(self._balance_loss(probs, group))
        return probs, cap, u

    def forward(self, x):
        """x [N, d_model] -> (combine [N, E, C], dispatch [N, E, C])."""
        probs, cap, u = self.route(x)
        return _dispatch_from_probs(
            probs, u, k=self.topk, capacity=cap, normalize=self._normalize,
            random2=self._random2 and self.training,
            group=self.batch_group())

    def _balance_loss(self, probs, group=None):
        # E * sum_e mean_tokens(prob_e) * frac_tokens(top1 == e), the
        # means over the batch group's tokens (module docstring)
        me = probs.mean(dim=0)
        ce = _one_hot(probs.argmax(dim=-1), self.tot_expert,
                      torch.float32).mean(dim=0)
        if group is not None:
            n = cf._pg(group)[1]
            me = cf.psum(me, group) / n
            with torch.no_grad():
                ce = cf.psum(ce, group) / n
        return (me * ce).sum() * float(self.tot_expert)


class GShardGate(NaiveGate):
    """Top-2 gate with capacity factors (1.2 in training, 2.4 in eval),
    the balance loss and random second-expert routing."""

    def __init__(self, d_model, num_expert, world_size, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None, **kw):
        super().__init__(d_model, num_expert, world_size, topk=topk,
                         group=group, **kw)
        self.capacity = capacity
        self._random2 = random_routing
        self._loss_kind = "gshard"

    def _train_factor(self):
        return self.capacity[0] if self.training else self.capacity[1]


class SwitchGate(NaiveGate):
    """Top-1 gate with multiplicative jitter in training (uniform in
    ``1 +- switch_eps``, from the gate's generator), the switch loss and
    capacity factors (1.2, 2.4)."""

    def __init__(self, d_model, num_expert, world_size, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, **kw):
        super().__init__(d_model, num_expert, world_size, topk=1,
                         group=group, **kw)
        self.switch_eps = switch_eps
        self.capacity = capacity
        self._normalize = False
        self._loss_kind = "switch"

    def _train_factor(self):
        return self.capacity[0] if self.training else self.capacity[1]

    def _jitter(self, x):
        if self.training and self.switch_eps > 0:
            noise = torch.rand(x.shape, generator=use_generator(
                self.generator), device=x.device, dtype=x.dtype)
            x = x * (noise * (2 * self.switch_eps) + (1.0 - self.switch_eps))
        return x
