"""Any validated schedule (1F1B, Eager1F1B, VPP, ZBH1, FThenB) run from
static routing tables over the ranks of a ``pp`` axis.

Counterpart of ``paddle_tpu/distributed/fleet/pipeline_spmd_engine.py``
(Paddle's ``passes/pipeline_scheduler_pass/``). The plan is plain
Python, carried over as it is: ``compile_pipeline_plan`` takes the
per-stage streams of ``meta_parallel/pipeline_schedules.py``, runs
``simulate``'s lockstep tick table, colours the lifetimes of every value
that crosses ticks (arrived activations, which double as the inputs a
backward recomputes from, arrived input gradients, and the last chunk's
loss gradient) into a pool of ``num_slots`` slots, and writes per-(tick,
stage) tables of what each stage runs, reads, writes and sends
(``PipelinePlan``). 1F1B and ZBH1 stay ``O(S)`` slots, FThenB ``O(M)``.

``pipeline_schedule_train_step`` runs a plan: the reference compiles it
into one ``lax.scan`` inside ``shard_map`` whose every cell computes a
forward and a vjp and masks the results; here each rank of the axis is
a process that runs, tick by tick, only its own cell's task (F: the
stage forward, and at the last chunk the loss and its gradient; B: the
input gradient of a recomputed forward, sent up the ring; W, or B where
the schedule has no W: the parameter gradients), then posts together
what the tables say it sends to its neighbours and receives from them
at that tick (``pipeline_spmd.tick_exchange``). Chunk ``c`` lives on stage
``c % S``, so the hops are always to the next and previous stage, the
ring wrapping for virtual chunks.

Tensor parallelism inside a stage (``param_pspecs``) and data
parallelism around the pipeline (``data_axis``) follow the reference:
``mp_copy`` (identity forward, all-reduce backward) on the input of a
column-parallel product and ``mp_reduce`` (all-reduce forward, identity
backward) on a row-parallel output, over the named axis of the mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..communication import _axis
from ..communication import functional as cf
from ..communication.group import axis_group
from .meta_parallel.pipeline_schedules import make_schedule, simulate
from .pipeline_spmd import _vjp, _loss_and_dy, tick_exchange

__all__ = ["compile_pipeline_plan", "pipeline_schedule_train_step",
           "stack_chunk_params", "mp_copy", "mp_reduce", "PipelinePlan"]


def mp_copy(x, axis):
    """Megatron's f: identity forward, the gradient all-reduced over the
    mesh's ``axis`` (the input of a column-parallel product, whose
    gradient is partial on each rank)."""
    return cf.reduce_bwd(x, _axis(axis))


def mp_reduce(x, axis):
    """Megatron's g: all-reduce forward over ``axis``, identity backward
    (a row-parallel output, whose gradient is already whole)."""
    return cf.reduce_fwd(x, _axis(axis))


# instruction opcodes in the kind table
_NOP, _F, _B, _W = 0, 1, 2, 3


class PipelinePlan(NamedTuple):
    """Static routing tables, one row per tick, one column per stage."""

    schedule: str
    S: int            # stages
    M: int            # microbatches
    vpp: int          # virtual chunks per stage
    C: int            # total chunks = S * vpp
    T: int            # ticks (simulate makespan)
    num_slots: int    # activation slot-pool size (liveness-colored)
    has_w: bool       # schedule splits backward into B (dx) + W (dparams)
    kind: np.ndarray          # [T, S] opcode
    micro: np.ndarray         # [T, S] microbatch id
    vchunk: np.ndarray        # [T, S] local virtual-chunk index (chunk // S)
    lastf: np.ndarray         # [T, S] 1 when F runs the LAST chunk (loss)
    fin_slot: np.ndarray      # [T, S] F input slot; -1 = read xs[micro]
    dy_write: np.ndarray      # [T, S] slot to store loss dy (last-chunk F)
    b_in: np.ndarray          # [T, S] B/W saved-input slot; -1 = xs[micro]
    b_dy: np.ndarray          # [T, S] B/W upstream-grad slot
    send_f: np.ndarray        # [T, S] 1 when F output ppermutes down-ring
    send_b: np.ndarray        # [T, S] 1 when B dx ppermutes up-ring
    recv_f: np.ndarray        # [T, S] slot for the fwd arrival; -1 = none
    recv_b: np.ndarray        # [T, S] slot for the bwd arrival; -1 = none
    # idle share of the simulated tick table (simulate's bubble_fraction)
    bubble_fraction: float

    def masked_compute_overhead(self) -> float:
        """The share of a lockstep run's compute that is masked out when
        every cell runs one forward and one full vjp (about 3 forwards),
        as the reference's compiled scan does: 1 - useful / total, an F
        or W cell worth 1 forward and a B cell 2 (1 when the schedule
        splits W off). The port runs only each cell's own task."""
        kinds = self.kind
        b_cost = 1.0 if self.has_w else 2.0
        cost = np.where(kinds == _B, b_cost,
                        np.where(kinds == _NOP, 0.0, 1.0))
        return float(1.0 - cost.sum() / (3.0 * kinds.size))


def _color_intervals(intervals: List[Tuple[int, int, object]]) -> Tuple[
        Dict[object, int], int]:
    """Greedy interval-graph coloring: (start, end, key) -> slot id.

    A slot is live on [start, end] inclusive; two intervals may share a
    slot iff they don't overlap. Returns ({key: slot}, num_slots)."""
    assignment: Dict[object, int] = {}
    free_at: List[int] = []   # per slot: first tick it is free again
    for start, end, key in sorted(intervals):
        for sid, fa in enumerate(free_at):
            if fa <= start:
                free_at[sid] = end + 1
                assignment[key] = sid
                break
        else:
            assignment[key] = len(free_at)
            free_at.append(end + 1)
    return assignment, max(len(free_at), 1)


def compile_pipeline_plan(schedule: str, S: int, M: int,
                          vpp: int = 1) -> PipelinePlan:
    """Lower a named schedule to the static routing tables.

    Runs the generators + dependency simulation (raising on any invalid
    schedule), then assigns every value that must cross ticks — arrived
    activations (doubling as remat inputs), arrived dx grads, and the
    last chunk's loss dy — to a liveness-colored slot pool."""
    streams = {s: make_schedule(schedule, s, S, M, vpp) for s in range(S)}
    sim = simulate(streams, S, M, vpp)
    ticks: List[Dict[int, Any]] = sim["ticks"]
    T = len(ticks)
    C = S * vpp
    has_w = any(t.kind == "W" for seq in streams.values() for t in seq)

    # tick of every task, keyed ("F"|"B"|"W", m, c)
    when: Dict[Tuple[str, int, int], int] = {}
    for t, assign in enumerate(ticks):
        for s, task in assign.items():
            when[(task.kind, task.micro, task.chunk)] = t

    def last_use(m: int, c: int) -> int:
        return when[("W", m, c)] if has_w else when[("B", m, c)]

    # ---- slot intervals, per stage ----------------------------------
    # key -> (stage, interval); three classes of slot tenants:
    #   ("act", m, c)  c > 0: F(m, c-1) output arrives at stage c%S one
    #                  tick after it ran upstream; retained (as the remat
    #                  input) until B/W(m, c).
    #   ("dy", m)      loss grad computed during F(m, C-1); retained
    #                  until B/W(m, C-1).
    #   ("grad", m, c) c < C-1: dx of B(m, c+1) arrives one tick later;
    #                  retained until B/W(m, c).
    per_stage: Dict[int, List[Tuple[int, int, object]]] = {
        s: [] for s in range(S)}
    for m in range(M):
        for c in range(C):
            stage = c % S
            if c > 0:
                arrive = when[("F", m, c - 1)] + 1
                per_stage[stage].append(
                    (arrive, last_use(m, c), ("act", m, c)))
            if c == C - 1:
                per_stage[stage].append(
                    (when[("F", m, c)], last_use(m, c), ("dy", m)))
            if c < C - 1:
                arrive = when[("B", m, c + 1)] + 1
                per_stage[stage].append(
                    (arrive, last_use(m, c), ("grad", m, c)))

    slot_of: Dict[int, Dict[object, int]] = {}
    num_slots = 1
    for s in range(S):
        slot_of[s], n = _color_intervals(per_stage[s])
        num_slots = max(num_slots, n)

    # ---- routing tables ---------------------------------------------
    def tbl(fill):
        return np.full((T, S), fill, dtype=np.int32)

    kind, micro, vchunk = tbl(_NOP), tbl(0), tbl(0)
    lastf, fin_slot, dy_write = tbl(0), tbl(-1), tbl(-1)
    b_in, b_dy = tbl(-1), tbl(-1)
    send_f, send_b, recv_f, recv_b = tbl(0), tbl(0), tbl(-1), tbl(-1)

    for t, assign in enumerate(ticks):
        for s, task in assign.items():
            k, m, c = task.kind, task.micro, task.chunk
            micro[t, s] = m
            vchunk[t, s] = c // S
            if k == "F":
                kind[t, s] = _F
                if c > 0:
                    fin_slot[t, s] = slot_of[s][("act", m, c)]
                if c == C - 1:
                    lastf[t, s] = 1
                    dy_write[t, s] = slot_of[s][("dy", m)]
                else:
                    send_f[t, s] = 1
                    # the arrival lands down-ring one tick later
                    ds = (s + 1) % S
                    recv_f[t + 1, ds] = slot_of[ds][("act", m, c + 1)]
            else:
                kind[t, s] = _B if k == "B" else _W
                if c > 0:
                    b_in[t, s] = slot_of[s][("act", m, c)]
                b_dy[t, s] = slot_of[s][
                    ("dy", m) if c == C - 1 else ("grad", m, c)]
                if k == "B" and c > 0:
                    send_b[t, s] = 1
                    us = (s - 1) % S
                    recv_b[t + 1, us] = slot_of[us][("grad", m, c - 1)]

    return PipelinePlan(
        schedule=schedule, S=S, M=M, vpp=vpp, C=C, T=T,
        num_slots=num_slots, has_w=has_w, kind=kind, micro=micro,
        vchunk=vchunk, lastf=lastf, fin_slot=fin_slot, dy_write=dy_write,
        b_in=b_in, b_dy=b_dy, send_f=send_f, send_b=send_b,
        recv_f=recv_f, recv_b=recv_b,
        bubble_fraction=float(sim["bubble_fraction"]))


def stack_chunk_params(per_chunk_params):
    """``C = S * vpp`` per-chunk pytrees (chunk ``c`` on stage ``c % S``,
    virtual index ``c // S``) as one pytree of ``[C, ...]`` leaves."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=0),
                    *per_chunk_params)


def _shard(leaf, spec, mesh):
    """This rank's block of ``leaf`` under ``spec`` (one mesh axis name
    or None a dim)."""
    for dim, name in enumerate(spec or ()):
        if name is None:
            continue
        group = axis_group(mesh, name)
        leaf = leaf.chunk(group.nranks, dim)[group.rank]
    return leaf


def _unshard(g, spec, mesh):
    """The whole of a gradient block ``g`` under ``spec``."""
    for dim, name in reversed(list(enumerate(spec or ()))):
        if name is not None:
            g = cf._gather(g.contiguous(), axis_group(mesh, name)
                           .process_group, dim)
    return g


def pipeline_schedule_train_step(stage_fn: Callable, loss_fn: Callable,
                                 chunk_params, micro_inputs, micro_labels,
                                 *, mesh, plan: PipelinePlan,
                                 axis: str = "pp", param_pspecs=None,
                                 data_axis: str = None):
    """One training step of ``plan`` (module docstring).

    ``stage_fn(params, x) -> y`` keeps ``x``'s shape and dtype;
    ``loss_fn(y, label) -> scalar``. ``chunk_params``: a pytree of
    ``[C, ...]`` leaves in chunk order, the same on every rank.
    ``micro_inputs [M, B, ...]`` and ``micro_labels [M, ...]`` the same on
    every rank. ``param_pspecs``: a pytree like ``chunk_params`` whose
    leaves are tuples naming, for each dim after the chunk dim, the mesh
    axis that shards it (or None): ``stage_fn`` then sees this rank's
    blocks and does its own tensor-parallel collectives with ``mp_copy``
    and ``mp_reduce``. ``data_axis``: micro-batch dim 1 is cut over it,
    each data-parallel line runs the schedule on its share, and the loss
    and gradients are averaged over it.

    Returns (the mean loss, on every rank; the gradients of the mean
    loss, ``[C, ...]`` whole, on every rank)."""
    S, M, vpp, C, T = plan.S, plan.M, plan.vpp, plan.C, plan.T
    if mesh.get_dim_size(axis) != S:
        raise ValueError(
            f"plan was compiled for {S} stages but mesh axis {axis!r} "
            f"has size {mesh.get_dim_size(axis)}")
    if micro_inputs.shape[0] != M:
        raise ValueError(
            f"plan was compiled for {M} microbatches, got "
            f"{micro_inputs.shape[0]}")
    group = axis_group(mesh, axis)
    p = group.rank
    xs, ys = micro_inputs, micro_labels
    if data_axis is not None:
        dp = axis_group(mesh, data_axis)
        xs = xs.chunk(dp.nranks, 1)[dp.rank]
        ys = ys.chunk(dp.nranks, 1)[dp.rank]
    leaves, spec = tree_flatten(chunk_params)
    pspecs = [None] * len(leaves) if param_pspecs is None else \
        tree_flatten(param_pspecs, is_leaf=lambda s: isinstance(s, tuple)
                     )[0]
    # this stage's chunks, virtual index v = c // S, each leaf this
    # rank's tensor-parallel block
    local = [[_shard(leaf[v * S + p], sp, mesh).detach()
              for leaf, sp in zip(leaves, pspecs)] for v in range(vpp)]
    grads = [[torch.zeros_like(x) for x in row] for row in local]
    slots: List[Any] = [None] * plan.num_slots
    loss = torch.zeros((), dtype=torch.float32, device=xs.device)
    act_in = grad_in = None
    with mesh:
        for t in range(T):
            # arrivals land first: a slot written this tick may be read
            # this tick
            if plan.recv_f[t, p] >= 0:
                slots[plan.recv_f[t, p]] = act_in
            if plan.recv_b[t, p] >= 0:
                slots[plan.recv_b[t, p]] = grad_in
            k, m, v = plan.kind[t, p], plan.micro[t, p], plan.vchunk[t, p]
            params_v = tree_unflatten(local[v], spec)
            act_send = grad_send = None
            if k == _F:
                fin = plan.fin_slot[t, p]
                x = slots[fin] if fin >= 0 else xs[m]
                with torch.no_grad():
                    y = stage_fn(params_v, x)
                if plan.lastf[t, p]:
                    lv, slots[plan.dy_write[t, p]] = _loss_and_dy(
                        loss_fn, y, ys[m])
                    loss = loss + lv
                elif plan.send_f[t, p]:
                    act_send = y
            elif k in (_B, _W):
                bin_ = plan.b_in[t, p]
                x = slots[bin_] if bin_ >= 0 else xs[m]
                dy = slots[plan.b_dy[t, p]]
                want_params = bool(k == _W or not plan.has_w)
                want_x = bool(k == _B and plan.send_b[t, p])
                if want_params or want_x:
                    dparams, dx = _vjp(stage_fn, params_v, x, dy,
                                       want_params, want_x)
                    if want_params:
                        for i, g in enumerate(tree_flatten(dparams)[0]):
                            grads[v][i] = grads[v][i] + g
                    grad_send = dx
            act_in, grad_in = tick_exchange(
                group, act_send, grad_send, xs[0],
                t + 1 < T and plan.recv_f[t + 1, p] >= 0,
                t + 1 < T and plan.recv_b[t + 1, p] >= 0)
    loss = cf.psum(loss, group) / M
    flat = []
    for i, sp in enumerate(pspecs):
        per_v = [_unshard(grads[v][i] / M, sp, mesh) for v in range(vpp)]
        mine = torch.stack(per_v)                         # [vpp, ...]
        every = cf._gather(mine.unsqueeze(1).contiguous(),
                           group.process_group, 1) if S > 1 \
            else mine.unsqueeze(1)                        # [vpp, S, ...]
        flat.append(every.reshape((C,) + tuple(every.shape[2:])))
    if data_axis is not None:
        dp = axis_group(mesh, data_axis)
        loss = cf._all_reduce(loss, dp.process_group) / dp.nranks \
            if dp.nranks > 1 else loss
        flat = [cf._all_reduce(g, dp.process_group) / dp.nranks
                if dp.nranks > 1 else g for g in flat]
    return loss, tree_unflatten(flat, spec)
