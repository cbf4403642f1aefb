"""The pipeline as one function over the ranks of a ``pp`` axis: GPipe
and 1F1B ticks, activations moved by a permute each tick.

Counterpart of ``paddle_tpu/distributed/fleet/pipeline_spmd.py``. The
reference stacks the stages' parameters on a leading axis sharded over
the mesh's ``pp`` axis and runs the schedule as one ``lax.scan`` inside
``shard_map``, a ``ppermute`` a tick. Here each rank of the axis is a
process: it holds the stacked parameters (every stage's, ``[S, ...]``
leaves, of which it reads its stage's row) or only its own row
(``[1, ...]`` leaves), and runs the same ticks eagerly:

- ``pipeline_spmd_apply``: ``M + S - 1`` ticks; at each one every stage
  runs ``stage_fn`` on its micro-batch (stage 0 takes the next input,
  the others what arrived the tick before) and the outputs move one
  stage down through ``communication.functional.permute``, whose
  backward moves the gradients back up. Every rank builds the same
  graph (a stage's unused branch is masked, not skipped), so the ranks'
  backwards run the same collectives in one order. The last stage's
  outputs are all-reduced to every rank, the backward keeping each
  rank's own gradient (``reduce_fwd``), as the reference's single
  program differentiates one loss.
- ``pipeline_spmd_train_step``: ``schedule="gpipe"`` is torch autograd
  through ``pipeline_spmd_apply``; ``"1f1b"`` runs the reference's
  closed-form tick map (``2 (M + S - 1)`` ticks, forward and backward
  parities disjoint on each stage), each stage keeping a ring of at
  most ``S`` saved inputs and recomputing its forward inside each
  backward tick, so live activations do not grow with ``M``. At each
  tick a rank posts together what it sends to its neighbours and what
  they send it (``tick_exchange``): the activation down, the gradient
  up, each straight to the next or previous stage. Returns the mean loss
  (on every rank) and the gradients of the mean loss, in the layout the
  parameters came in (whole stacks gathered over the axis).

``stage_fn(params, x) -> y`` must keep ``x``'s shape and dtype;
``loss_fn(y, label) -> scalar``; ``micro_inputs`` ``[M, B, ...]`` and
``micro_labels`` ``[M, ...]`` are the same on every rank.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..communication import functional as cf
from ..communication.group import axis_group

__all__ = ["pipeline_spmd_apply", "pipeline_spmd_train_step",
           "stack_stage_params"]

# the saved-input ring of the last 1F1B call, (S,) + the micro-batch's
# shape: its size is the schedule's liveness bound
_LAST_1F1B_RING_SHAPES: dict = {}


def stack_stage_params(per_stage_params):
    """S per-stage pytrees of one structure as one pytree of ``[S, ...]``
    leaves."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=0),
                    *per_stage_params)


def _axis(mesh, axis):
    group = axis_group(mesh, axis)
    if group.rank < 0:
        raise ValueError(f"pipeline: this rank is not on the mesh's "
                         f"{axis!r} axis")
    return group, group.nranks, group.rank


def _row(leaf, S, stage):
    """This stage's row of a leaf: ``[S, ...]`` (every stage's) or
    ``[1, ...]`` (this rank's own)."""
    n = leaf.shape[0]
    if n == S:
        return leaf[stage]
    if n == 1:
        return leaf[0]
    raise ValueError(f"pipeline: a stacked parameter has {n} rows; the axis "
                     f"has {S} stages")


def _in_layout(grads, like, group, S):
    """``grads`` (this stage's) in the layout of ``like``: whole stacks
    gathered over the axis, one-row stacks as they are."""
    def one(g, leaf):
        g = g.unsqueeze(0)
        if leaf.shape[0] == 1 and S > 1:
            return g
        return cf._gather(g.contiguous(), group.process_group, 0) \
            if S > 1 else g
    return tree_map(one, grads, like)


def _masked(flag, a, b):
    return torch.where(torch.tensor(bool(flag), device=a.device), a, b)


def _apply_local(stage_fn, local, xs, group, S, stage):
    M = xs.shape[0]
    perm = [(i, (i + 1) % S) for i in range(S)]
    state = torch.zeros_like(xs[0])
    ys = []
    for t in range(M + S - 1):
        # stage 0 ingests micro-batch t (the last again while the
        # pipeline drains); the others take what arrived last tick
        x = _masked(stage == 0, xs[min(t, M - 1)], state)
        y = stage_fn(local, x)
        ys.append(y)
        state = cf.permute(y, group, perm)
    outs = torch.stack(ys[S - 1:])
    outs = _masked(stage == S - 1, outs, torch.zeros_like(outs))
    return cf.reduce_fwd(outs, group)


def pipeline_spmd_apply(stage_fn: Callable, stacked_params: Any,
                        micro_inputs, *, mesh, axis: str = "pp"):
    """``M`` micro-batches through the ``S`` stages of ``mesh``'s
    ``axis`` (module docstring): ``[M, micro_batch, ...]``, the last
    stage's outputs, on every rank."""
    group, S, stage = _axis(mesh, axis)
    local = tree_map(lambda a: _row(a, S, stage), stacked_params)
    return _apply_local(stage_fn, local, micro_inputs, group, S, stage)


def _fwd_micro(p, t, S, M):
    """The micro-batch stage ``p`` runs forward at tick ``t`` of 1F1B, or
    None: warm-up ``f = t - p`` for ``f < S - p``, then ``t = 2 f + p``."""
    if t < S:
        f = t - p
        return f if 0 <= f < min(M, S - p) else None
    if (t - p) % 2 == 0 and S - p <= (t - p) // 2 < M:
        return (t - p) // 2
    return None


def _bwd_micro(p, t, S, M):
    """The micro-batch stage ``p`` runs backward at tick ``t`` of 1F1B
    (``t = 2 b + 2 S - 1 - p``), or None."""
    u = t - (2 * S - 1 - p)
    return u // 2 if u >= 0 and u % 2 == 0 and u // 2 < M else None


def tick_exchange(group, act, grad, like, recv_act, recv_grad):
    """One tick's transfers over the ring of ``group``, posted together
    (``communication.functional._p2p``): this rank's activation, if any,
    to the next stage and its input gradient, if any, to the previous
    one; an activation from the previous stage if ``recv_act`` and a
    gradient from the next if ``recv_grad``, each of ``like``'s shape
    and dtype. Returns (the activation in, the gradient in), None where
    nothing arrives."""
    n, me = group.nranks, group.rank
    sends = [(x, (me + hop) % n, tag)
             for x, hop, tag in ((act, 1, 0), (grad, -1, 1))
             if x is not None]
    recvs = [(like.shape, like.dtype, (me + hop) % n, tag)
             for want, hop, tag in ((recv_act, -1, 0), (recv_grad, 1, 1))
             if want]
    got = iter(cf._p2p(group.process_group, sends, recvs, like.device))
    return (next(got) if recv_act else None,
            next(got) if recv_grad else None)


def _vjp(stage_fn, params, x, dy, want_params=True, want_x=True):
    """(d params, dx) of ``stage_fn(params, x)`` against ``dy``, the
    forward recomputed."""
    leaves, spec = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    xr = x.detach().requires_grad_(want_x)
    y = stage_fn(tree_unflatten(leaves, spec), xr)
    wrt = (leaves if want_params else []) + ([xr] if want_x else [])
    got = torch.autograd.grad([y], wrt, [dy], allow_unused=True)
    dparams = None
    if want_params:
        dparams = tree_unflatten(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, got[:len(leaves)])], spec)
    return dparams, (got[-1] if want_x else None)


def _loss_and_dy(loss_fn, y, label):
    yy = y.detach().requires_grad_()
    loss = loss_fn(yy, label).float()
    (dy,) = torch.autograd.grad([loss], [yy])
    return loss.detach(), dy


def _train_1f1b(stage_fn, loss_fn, local, xs, ys, group, S, stage):
    M = xs.shape[0]
    T = 2 * (M + S - 1)
    act_ring = [None] * S          # arrived, not yet consumed
    in_ring = [None] * S           # saved stage inputs for the backward
    grads = tree_map(torch.zeros_like, local)
    loss = torch.zeros((), dtype=torch.float32, device=xs.device)
    dy_slot = None
    arrival = grad_in = None
    _LAST_1F1B_RING_SHAPES["in_ring"] = (S,) + tuple(xs.shape[1:])
    for t in range(T):
        if arrival is not None:
            act_ring[arrival[0] % S] = arrival[1]
        grad_send = act_send = None
        b = _bwd_micro(stage, t, S, M)
        if b is not None:
            gin = dy_slot if stage == S - 1 else grad_in
            dparams, dx = _vjp(stage_fn, local, in_ring[b % S], gin,
                               want_x=stage > 0)
            grads = tree_map(torch.add, grads, dparams)
            grad_send = dx
        f = _fwd_micro(stage, t, S, M)
        if f is not None:
            x_in = xs[f] if stage == 0 else act_ring[f % S]
            in_ring[f % S] = x_in
            with torch.no_grad():
                y = stage_fn(local, x_in)
            if stage == S - 1:
                lv, dy_slot = _loss_and_dy(loss_fn, y, ys[f])
                loss = loss + lv
            else:
                act_send = y
        # what moves this tick, the same on every rank
        sends_f = [p for p in range(S - 1)
                   if _fwd_micro(p, t, S, M) is not None]
        sends_b = [p for p in range(1, S)
                   if _bwd_micro(p, t, S, M) is not None]
        act_in, grad_in = tick_exchange(group, act_send, grad_send, xs[0],
                                        stage - 1 in sends_f,
                                        stage + 1 in sends_b)
        arrival = None if act_in is None \
            else (_fwd_micro(stage - 1, t, S, M), act_in)
    return loss, grads


def pipeline_spmd_train_step(stage_fn, loss_fn, stacked_params, micro_inputs,
                             micro_labels, *, mesh, axis: str = "pp",
                             schedule: str = "1f1b"):
    """One training step of the pipeline (module docstring): (mean loss,
    gradients of the mean loss in ``stacked_params``' layout)."""
    group, S, stage = _axis(mesh, axis)
    M = micro_inputs.shape[0]
    local = tree_map(lambda a: _row(a, S, stage).detach(), stacked_params)
    if schedule == "gpipe":
        leaves, spec = tree_flatten(local)
        leaves = [p.requires_grad_() for p in leaves]
        outs = _apply_local(stage_fn, tree_unflatten(leaves, spec),
                            micro_inputs, group, S, stage)
        loss = torch.stack([loss_fn(outs[m], micro_labels[m]).float()
                            for m in range(M)]).mean()
        got = torch.autograd.grad([loss], leaves, allow_unused=True)
        grads = tree_unflatten([torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, got)], spec)
        return loss.detach(), _in_layout(grads, stacked_params, group, S)
    if schedule != "1f1b":
        raise ValueError(f"unknown pipeline schedule: {schedule!r}")
    loss, grads = _train_1f1b(stage_fn, loss_fn, local, micro_inputs,
                              micro_labels, group, S, stage)
    loss = cf.psum(loss, group) / M
    grads = tree_map(lambda g: g / M, grads)
    return loss, _in_layout(grads, stacked_params, group, S)
