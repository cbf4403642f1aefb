"""Differentiable collectives over a ``torch.distributed`` process group.

The building blocks of the in-trace collectives (``psum``,
``all_gather_in_trace``, ``ppermute``, ``all_to_all_in_trace``) and of
the tensor- and sequence-parallel layers (``fleet/mp_layers.py``,
``fleet/sequence_parallel.py``). Each is an ``autograd.Function`` whose
backward is the transpose its use needs:

===================  ==========================  =========================
function             forward                     backward
===================  ==========================  =========================
``psum``             all-reduce (sum)            all-reduce (sum), as
                                                 ``jax.grad`` of ``lax.psum``
``reduce_fwd``       all-reduce (sum)            identity (Megatron's g)
``reduce_bwd``       identity                    all-reduce (sum) (f)
``all_gather``       all-gather along ``dim``    reduce-scatter (sum)
``gather``           all-gather along ``dim``    this rank's chunk
``split``            this rank's chunk           all-gather
``reduce_scatter``   reduce-scatter (sum)        all-gather
``permute``          ``ppermute`` by ``perm``    ``ppermute`` by its inverse
``all_to_all``       split, exchange, concat     the same, axes swapped
===================  ==========================  =========================

A group of one rank makes each of them the identity (a chunk of one is
the whole). ``permute`` moves each tensor straight to its destination:
a rank posts its one send and its one receive together (``_p2p``) and
waits on both, so no order of the ranks' transfers can deadlock.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

__all__ = ["psum", "reduce_fwd", "reduce_bwd", "all_gather", "gather",
           "split", "reduce_scatter", "permute", "all_to_all"]


def _size(pg) -> int:
    return 1 if pg is None else tdist.get_world_size(pg)


def _rank(pg) -> int:
    return 0 if pg is None else tdist.get_rank(pg)


def _all_reduce(x, pg):
    x = x.contiguous().clone()
    tdist.all_reduce(x, group=pg)
    return x


def _gather(x, pg, dim):
    n = _size(pg)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    tdist.all_gather_into_tensor(out, x, group=pg)
    return out.movedim(0, dim).contiguous()


def _chunk(x, pg, dim):
    n = _size(pg)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    return x.chunk(n, dim)[_rank(pg)].contiguous()


def _reduce_scatter(x, pg, dim):
    n = _size(pg)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    tdist.reduce_scatter_tensor(out, x, group=pg)
    return out.movedim(0, dim).contiguous()


def _p2p(pg, sends, recvs, device):
    """Point-to-point transfers over ``pg``, every one of this rank's
    posted together and then waited on: ``sends`` ``(tensor, dst, tag)``
    and ``recvs`` ``(shape, dtype, src, tag)``, peers by group rank.
    The ranks must list their transfers in one order (a sender's i-th
    send to a peer is that peer's i-th receive from it with the same
    tag). Returns the received tensors on ``device``. gloo carries no
    point-to-point transfer of CUDA tensors, so there they go through
    the host."""
    host = torch.device(device).type != "cpu" and \
        tdist.get_backend(pg) == "gloo"
    ops, bufs = [], []
    for t, dst, tag in sends:
        t = t.detach().contiguous()
        ops.append(tdist.P2POp(tdist.isend, t.cpu() if host else t,
                               tdist.get_global_rank(pg, dst), pg, tag))
    for shape, dtype, src, tag in recvs:
        bufs.append(torch.empty(shape, dtype=dtype,
                                device="cpu" if host else device))
        ops.append(tdist.P2POp(tdist.irecv, bufs[-1],
                               tdist.get_global_rank(pg, src), pg, tag))
    if ops:
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(device) for b in bufs] if host else bufs


def _permute(x, pg, perm):
    """Rank ``dst`` of each ``(src, dst)`` pair gets rank ``src``'s ``x``;
    a rank no pair sends to gets zeros (``lax.ppermute``)."""
    me = _rank(pg)
    x = x.contiguous()
    dsts = [d for s, d in perm if s == me and d != me]
    srcs = [s for s, d in perm if d == me]
    got = _p2p(pg, [(x, d, 0) for d in dsts],
               [(x.shape, x.dtype, s, 0) for s in srcs if s != me],
               x.device)
    if not srcs:
        return torch.zeros_like(x)
    return x.clone() if srcs[0] == me else got[0]


def _all_to_all(x, pg, split_axis, concat_axis):
    n = _size(pg)
    ins = [c.contiguous() for c in x.chunk(n, split_axis)]
    outs = [torch.empty_like(ins[0]) for _ in range(n)]
    tdist.all_to_all(outs, ins, group=pg)
    return torch.cat(outs, dim=concat_axis)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _all_reduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.pg), None


class _ReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.pg), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return _gather(x, pg, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.pg, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return _gather(x, pg, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.pg, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return _chunk(x, pg, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.pg, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, dim):
        ctx.pg, ctx.dim = pg, dim
        return _reduce_scatter(x, pg, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.pg, ctx.dim), None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, perm):
        ctx.pg, ctx.perm = pg, perm
        return _permute(x, pg, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.pg, inverse), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, split_axis, concat_axis):
        ctx.pg, ctx.axes = pg, (split_axis, concat_axis)
        return _all_to_all(x, pg, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, ctx.pg, concat_axis, split_axis), None, None, \
            None


def _pg(group):
    """(the torch process group, its size) of a port ``Group``, a torch
    group or None (the identity of one rank). A port group knows its size
    (``nranks``), which saves asking torch on every call."""
    if group is None:
        return None, 1
    pg = getattr(group, "process_group", group)
    n = getattr(group, "nranks", None)
    return pg, (_size(pg) if n is None else n)


def psum(x, group):
    pg, n = _pg(group)
    return x if n == 1 else _Psum.apply(x, pg)


def reduce_fwd(x, group):
    pg, n = _pg(group)
    return x if n == 1 else _ReduceFwd.apply(x, pg)


def reduce_bwd(x, group):
    pg, n = _pg(group)
    return x if n == 1 else _ReduceBwd.apply(x, pg)


def all_gather(x, group, dim=0):
    pg, n = _pg(group)
    return x if n == 1 else _AllGather.apply(x, pg, dim % x.ndim)


def gather(x, group, dim=-1):
    pg, n = _pg(group)
    return x if n == 1 else _Gather.apply(x, pg, dim % x.ndim)


def split(x, group, dim=-1):
    pg, n = _pg(group)
    return x if n == 1 else _Split.apply(x, pg, dim % x.ndim)


def reduce_scatter(x, group, dim=0):
    pg, n = _pg(group)
    return x if n == 1 else _ReduceScatter.apply(x, pg, dim % x.ndim)


def permute(x, group, perm):
    pg, n = _pg(group)
    perm = [(int(s), int(d)) for s, d in perm]
    if n == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Permute.apply(x, pg, perm)


def all_to_all(x, group, split_axis, concat_axis):
    pg, n = _pg(group)
    if n == 1:
        return x
    return _AllToAll.apply(x, pg, split_axis % x.ndim, concat_axis % x.ndim)
