"""Pipeline schedule generators and their discrete-event validator.

Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_schedules.py``
(Paddle's ``passes/pipeline_scheduler_pass/``: FThenB, 1F1B, interleaved
VPP, zero-bubble ZBH1), the same pure Python. Each generator emits one
stage's instruction stream of ``Task(kind, micro, chunk)`` items: kind
'F' (forward), 'B' (backward of the activations) or 'W' (the deferred
weight gradient, zero-bubble only). ``simulate`` runs all streams
against the cross-stage dependency rules, rejects deadlocks and
incomplete schedules, reports the bubble and peak-activation numbers,
and returns the global order and the lockstep tick table that
``PipelineParallel`` and ``pipeline_spmd_engine`` execute.

Chunk convention (Megatron interleaving): the model is cut into
``num_stages * vpp`` chunks; chunk ``c`` lives on stage ``c % num_stages``
with virtual index ``c // num_stages``; the forward chain runs chunks in
ascending ``c``.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Dict, List

Task = namedtuple("Task", ["kind", "micro", "chunk"])

__all__ = ["Task", "make_schedule", "fthenb_schedule", "one_f_one_b_schedule",
           "eager_1f1b_schedule", "vpp_schedule", "zbh1_schedule", "simulate"]


def fthenb_schedule(stage: int, num_stages: int, num_micro: int) -> List[Task]:
    """All forwards then all backwards (reference FThenB pass)."""
    return [Task("F", m, stage) for m in range(num_micro)] + [
        Task("B", m, stage) for m in range(num_micro)
    ]


def _1f1b_core(warmup_depth: int, stage: int, num_micro: int) -> List[Task]:
    """Shared 1F1B shape: warmup forwards, steady F+B, cooldown B."""
    warmup = min(warmup_depth, num_micro)
    seq: List[Task] = [Task("F", m, stage) for m in range(warmup)]
    f_next, b_next = warmup, 0
    while b_next < num_micro:
        if f_next < num_micro:
            seq.append(Task("F", f_next, stage))
            f_next += 1
        seq.append(Task("B", b_next, stage))
        b_next += 1
    return seq


def one_f_one_b_schedule(stage: int, num_stages: int, num_micro: int) -> List[Task]:
    """Classic 1F1B (reference pipeline_parallel.py:229): warmup of
    (num_stages - stage - 1) forwards, steady 1F1B, cooldown backwards."""
    return _1f1b_core(num_stages - stage - 1, stage, num_micro)


def eager_1f1b_schedule(stage: int, num_stages: int,
                        num_micro: int) -> List[Task]:
    """Eager-1F1B (reference pipeline_scheduler_pass Eager1F1B): 1F1B
    with a ONE-forward-deeper warmup per stage, so every stage holds one
    extra in-flight micro-batch. The extra eager forward lets the stage
    overlap its next forward with the neighbor's send/recv at the cost
    of one more activation slot — same bubble as 1F1B, different
    memory/overlap trade."""
    return _1f1b_core(num_stages - stage, stage, num_micro)


def vpp_schedule(stage: int, num_stages: int, num_micro: int, vpp: int) -> List[Task]:
    """Interleaved 1F1B / virtual pipeline (reference
    pipeline_parallel.py:1136, Megatron interleaving). Requires
    num_micro % num_stages == 0."""
    if num_micro % num_stages:
        raise ValueError(
            f"interleaved schedule requires num_micro ({num_micro}) divisible "
            f"by num_stages ({num_stages})"
        )
    total = num_micro * vpp
    group = num_stages * vpp

    def fwd_task(k: int) -> Task:
        g = k % group
        vchunk = g // num_stages
        micro = (k // group) * num_stages + (g % num_stages)
        return Task("F", micro, vchunk * num_stages + stage)

    def bwd_task(k: int) -> Task:
        g = k % group
        vchunk = vpp - 1 - g // num_stages
        micro = (k // group) * num_stages + (g % num_stages)
        return Task("B", micro, vchunk * num_stages + stage)

    warmup = min(total, (num_stages - stage - 1) * 2 + (vpp - 1) * num_stages)
    seq = [fwd_task(k) for k in range(warmup)]
    f_next, b_next = warmup, 0
    while b_next < total:
        if f_next < total:
            seq.append(fwd_task(f_next))
            f_next += 1
        seq.append(bwd_task(b_next))
        b_next += 1
    return seq


def zbh1_schedule(stage: int, num_stages: int, num_micro: int) -> List[Task]:
    """ZB-H1 zero-bubble (reference pipeline_zero_bubble.py; Qi et al.,
    "Zero Bubble Pipeline Parallelism"): backward splits into B (activation
    grad, on the critical path) and W (weight grad, filler). Warmup is one
    forward deeper than 1F1B, and W's fill the cooldown bubbles."""
    warmup = min(num_stages - stage, num_micro)
    seq: List[Task] = [Task("F", m, stage) for m in range(warmup)]
    f_next, b_next, w_next = warmup, 0, 0
    while b_next < num_micro:
        seq.append(Task("B", b_next, stage))
        b_next += 1
        if f_next < num_micro:
            seq.append(Task("F", f_next, stage))
            f_next += 1
        elif w_next < b_next:
            seq.append(Task("W", w_next, stage))
            w_next += 1
    while w_next < num_micro:
        seq.append(Task("W", w_next, stage))
        w_next += 1
    return seq


def make_schedule(mode: str, stage: int, num_stages: int, num_micro: int,
                  vpp: int = 1) -> List[Task]:
    mode = mode.upper().replace("-", "").replace("_", "")
    if mode == "FTHENB":
        return fthenb_schedule(stage, num_stages, num_micro)
    if mode == "1F1B":
        return one_f_one_b_schedule(stage, num_stages, num_micro)
    if mode == "EAGER1F1B":
        return eager_1f1b_schedule(stage, num_stages, num_micro)
    if mode in ("VPP", "INTERLEAVED", "INTERLEAVED1F1B"):
        return vpp_schedule(stage, num_stages, num_micro, vpp)
    if mode in ("ZBH1", "ZEROBUBBLE"):
        return zbh1_schedule(stage, num_stages, num_micro)
    raise ValueError(f"unknown pipeline schedule mode: {mode}")


def simulate(streams: Dict[int, List[Task]], num_stages: int, num_micro: int,
             vpp: int = 1):
    """Discrete-event simulation with unit task cost.

    Dependency rules:
      F(m, c)  needs F(m, c-1) done (c > 0);
      B(m, c)  needs F(m, last_chunk) done and B(m, c+1) done (c < last);
      W(m, c)  needs B(m, c) done.
    Raises on deadlock or incomplete coverage. Returns
    {order, makespan, bubble_fraction, peak_activations, ticks} — ticks
    is the lockstep tick table: one {stage: Task} dict per unit-time
    step, the plan that PipelineParallel over ranks runs and that
    fleet/pipeline_spmd_engine.py turns into its routing tables.
    """
    num_chunks = num_stages * vpp
    done = set()          # ("F"|"B"|"W", micro, chunk) completed
    pos = {s: 0 for s in streams}
    order = []
    live = {s: 0 for s in streams}      # activations held per stage
    peak = {s: 0 for s in streams}
    busy = {s: 0 for s in streams}
    has_w = any(t.kind == "W" for seq in streams.values() for t in seq)

    def ready(task) -> bool:
        k, m, c = task
        if k == "F":
            return c == 0 or ("F", m, c - 1) in done
        if k == "B":
            if ("F", m, num_chunks - 1) not in done:
                return False
            return c == num_chunks - 1 or ("B", m, c + 1) in done
        return ("B", m, c) in done       # W

    t = 0
    total = sum(len(seq) for seq in streams.values())
    ticks: List[Dict[int, Task]] = []
    while len(done) < total:
        progressed = False
        completed_now = []
        for s in sorted(streams):
            if pos[s] >= len(streams[s]):
                continue
            task = streams[s][pos[s]]
            if ready(task):
                completed_now.append((s, task))
                order.append((s, task))
                busy[s] += 1
                if task.kind == "F":
                    live[s] += 1
                    peak[s] = max(peak[s], live[s])
                elif (task.kind == "B" and not has_w) or task.kind == "W":
                    live[s] -= 1
                progressed = True
        for s, task in completed_now:
            done.add((task.kind, task.micro, task.chunk))
            pos[s] += 1
        ticks.append(dict(completed_now))
        if not progressed:
            stuck = {s: streams[s][pos[s]] for s in streams if pos[s] < len(streams[s])}
            raise RuntimeError(f"pipeline schedule deadlock at t={t}: {stuck}")
        t += 1

    makespan = t
    bubbles = sum(makespan - busy[s] for s in streams)
    return {
        "order": order,
        "makespan": makespan,
        "bubble_fraction": bubbles / (makespan * num_stages),
        "peak_activations": peak,
        "ticks": ticks,
    }
