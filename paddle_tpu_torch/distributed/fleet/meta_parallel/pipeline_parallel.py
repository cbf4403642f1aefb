"""``PipelineParallel``: a ``PipelineLayer`` trained micro-batch by
micro-batch under a schedule.

Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``
(Paddle's ``pipeline_parallel.py``: ``train_batch``, ``eval_batch``,
FThenB, 1F1B, Eager1F1B, interleaved VPP and zero-bubble ZBH1 from
``strategy.pipeline_configs``: ``accumulate_steps`` micro-batches a
batch, ``schedule_mode``).

In one process (no pipeline group, or ``pp_degree`` 1) every stage is
here, as in the reference's single controller, and the schedule is an
order of the micro-batches' forward and backward work: FThenB, 1F1B and
Eager1F1B run each micro-batch through the whole model; VPP and ZBH1
replay ``simulate``'s global order chunk by chunk, each chunk's input a
detached leaf, ZBH1 deferring the weight gradients to its W tasks.

Over a pipeline group of ``n`` ranks each rank holds its stage
(``PipelineLayer.stage_layers``) and every schedule runs as
``simulate``'s lockstep tick table: at each tick a rank runs its own
task, if it has one, and then posts together the transfers the table
gives it for that tick, its activation to the next stage or its input
gradient to the previous one and what its neighbours send it
(``communication.functional._p2p``), and waits on them. Every rank
reads the same table, so each send is paired with its receive and no
order of the transfers can deadlock; a tick moves only what it sends,
neighbour to neighbour. The first transfer of each (kind, chunk) is
preceded by one of its shape and dtype; later ones reuse them. The last
stage's mean loss is all-reduced to every rank, and the weights
``SharedLayerDesc`` ties are summed over the stages that hold them.
Values equal the single-process run's. A data-parallel degree above 1
around the pipeline raises ``NotImplementedError``: its ranks would
need the stages' weights made equal and their gradients averaged, which
waits for a later slice.

Public point-to-point (``paddle.distributed.send`` and its kin) still
raises, as the reference's does: the transport is internal, as the
reference's ``ppermute`` is.
"""
from __future__ import annotations

from typing import List

import torch

from .pipeline_schedules import make_schedule, simulate
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]

_TASK_MODES = ("VPP", "INTERLEAVED", "INTERLEAVED1F1B", "ZBH1", "ZEROBUBBLE")
_ZB_MODES = ("ZBH1", "ZEROBUBBLE")
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_META = 8                       # dtype, ndim, up to 6 dims


def _mode(schedule_mode) -> str:
    return str(schedule_mode).upper().replace("-", "").replace("_", "")


def _accumulate(p, g):
    if g is None:
        return
    if p.grad is None:
        p.grad = g.detach().clone()
    else:
        p.grad.add_(g)


def _transfers(assign, S, last):
    """What a tick of the table (``assign``: stage -> task) sends: each
    sending stage's ``((kind, chunk), receiving stage)``, an F's output
    to the stage of the next chunk and a B's input gradient to the stage
    of the previous one (chunk ``c`` lives on stage ``c % S``)."""
    return {s: ((t.kind, t.chunk),
                (t.chunk + (1 if t.kind == "F" else -1)) % S)
            for s, t in assign.items()
            if (t.kind == "F" and t.chunk < last)
            or (t.kind == "B" and t.chunk > 0)}


class _Exchange:
    """The pipeline's transport over its group: ``run(stage, payload,
    transfers)`` posts this tick's transfers (``transfers``: each sending
    stage's ``((kind, chunk), receiving stage)``, the same on every rank)
    that this rank takes part in, sending ``payload`` and returning what
    it receives by sending stage. A (kind, chunk) always goes between the
    same two stages; the first time one is sent its shape and dtype go
    ahead of it."""

    def __init__(self, group, device):
        self.group = group
        self.pg = group.process_group
        self.device = device
        self.seen = set()            # every (kind, chunk) sent so far
        self.meta = {}               # (kind, chunk) -> (shape, dtype)
        self.bytes_sent = 0          # payload bytes this rank has sent

    def _p2p(self, sends, recvs):
        from ...communication.functional import _p2p

        return _p2p(self.pg, sends, recvs, self.device)

    def _learn(self, stage, payload, transfers):
        new = {s: v for s, v in transfers.items() if v[0] not in self.seen}
        if not new:
            return
        sends = []
        if stage in new:
            row = torch.zeros(_META, dtype=torch.int64)
            row[0], row[1] = _DTYPES.index(payload.dtype), payload.ndim
            row[2:2 + payload.ndim] = torch.tensor(payload.shape)
            sends.append((row.to(self.device), new[stage][1], 0))
        into = [(s, key) for s, (key, r) in new.items() if r == stage]
        rows = self._p2p(sends, [((_META,), torch.int64, s, 0)
                                 for s, _ in into])
        for (_, key), row in zip(into, rows):
            code, ndim, *dims = row.tolist()
            self.meta[key] = (tuple(dims[:ndim]), _DTYPES[code])
        self.seen.update(key for key, _ in new.values())

    def run(self, stage, payload, transfers):
        if stage in transfers and payload is None:
            raise RuntimeError(f"pipeline: stage {stage} has nothing to "
                               f"send for {transfers[stage][0]}")
        self._learn(stage, payload, transfers)
        sends = []
        if stage in transfers:
            sends.append((payload, transfers[stage][1], 0))
            self.bytes_sent += payload.numel() * payload.element_size()
        into = [(s, key) for s, (key, r) in transfers.items() if r == stage]
        got = self._p2p(sends, [self.meta[key] + (s, 0) for s, key in into])
        return {s: x for (s, _), x in zip(into, got)}


class PipelineParallel(torch.nn.Module):
    """A ``PipelineLayer`` under ``strategy.pipeline_configs`` (module
    docstring)."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError(
                "The Layer should be a derived class of PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = getattr(strategy, "pipeline_configs", {}) if strategy else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.schedule_mode = str(cfg.get("schedule_mode", "1F1B"))
        self.num_stages = layers.num_stages
        if layers.stage is not None and \
                layers._hcg.get_data_parallel_world_size() > 1:
            raise NotImplementedError(
                "PipelineParallel over pipeline ranks with a data-parallel "
                "degree above 1 waits for a later slice of the port")
        self.total_loss = None
        self._exchange = None
        self._plans = {}

    # ------------------------------------------------------------------
    def _split_micro(self, data):
        """A batch (a tensor, or an [inputs, labels] pair) as
        ``accumulate_steps`` micro-batches along dim 0."""
        m = self.accumulate_steps

        def split_one(t):
            n = t.shape[0]
            if n % m:
                raise ValueError(
                    f"batch dim {n} not divisible by accumulate_steps {m}")
            return list(t.chunk(m, dim=0))

        if isinstance(data, (tuple, list)):
            return list(zip(*[split_one(t) for t in data]))
        return [(x,) for x in split_one(data)]

    def _forward_micro(self, micro):
        *inputs, label = micro if len(micro) > 1 else (micro[0], None)
        out = self._layers(*inputs)
        if self._layers._loss_fn is not None and label is not None:
            return self._layers._loss_fn(out, label)
        return out

    def _last_output(self, out, micro, m, scaler):
        """The last chunk's output of ``micro`` as its share of the mean
        loss (the loss over ``m``, scaled by ``scaler``)."""
        label = micro[-1] if len(micro) > 1 else None
        if self._layers._loss_fn is not None and label is not None:
            out = self._layers._loss_fn(out, label)
        out = out * (1.0 / m)
        return scaler.scale(out) if scaler is not None else out

    # ------------------------------------------------------------------
    def forward_backward_pipeline(self, data, scaler=None):
        """One batch through the schedule; returns the mean loss (on every
        rank of a pipeline group)."""
        micros = self._split_micro(data)
        m = len(micros)
        mode = _mode(self.schedule_mode)
        if mode in _ZB_MODES and self._layers._num_virtual_stages > 1:
            raise ValueError(
                "ZBH1 does not compose with virtual pipeline stages; use "
                "num_virtual_pipeline_stages=1 or schedule_mode='VPP'")
        if self._layers.stage is not None:
            return self._run_over_ranks(micros, scaler, mode)
        if mode in _TASK_MODES:
            return self._run_task_schedule(micros, scaler, mode)
        losses: List[torch.Tensor] = []
        if mode == "FTHENB":
            for micro in micros:
                losses.append(self._forward_micro(micro))
            for loss in losses:
                self._backward_one(loss, m, scaler)
        else:
            # 1F1B: warm-up forwards, steady one forward one backward,
            # cool-down backwards; Eager1F1B warms up one forward deeper
            depth = self.num_stages if mode == "EAGER1F1B" \
                else self.num_stages - 1
            pending: List[torch.Tensor] = []
            for i in range(min(depth, m)):
                pending.append(self._forward_micro(micros[i]))
            for i in range(min(depth, m), m):
                pending.append(self._forward_micro(micros[i]))
                losses.append(pending.pop(0))
                self._backward_one(losses[-1], m, scaler)
            while pending:
                losses.append(pending.pop(0))
                self._backward_one(losses[-1], m, scaler)
        return torch.stack([loss.detach() for loss in losses]).sum() \
            * (1.0 / m)

    def _backward_one(self, loss, m, scaler):
        scaled = loss * (1.0 / m)
        (scaler.scale(scaled) if scaler is not None else scaled).backward()

    def _plan(self, mode, m, forward_only=False):
        """(tick table, each chunk's parameters) of ``mode`` at ``m``
        micro-batches, made once."""
        key = (mode, m, forward_only)
        if key not in self._plans:
            pp, vpp = self.num_stages, self._layers._num_virtual_stages
            if forward_only:
                streams = {s: [t for t in make_schedule(
                    "VPP" if vpp > 1 else "FTHENB", s, pp, m, vpp)
                    if t.kind == "F"] for s in range(pp)}
            else:
                streams = {s: make_schedule(mode, s, pp, m, vpp)
                           for s in range(pp)}
            sim = simulate(streams, pp, m, vpp)
            params = {c: self._layers.chunk_parameters(c)
                      for c in range(self._layers.num_chunks)}
            self._plans[key] = (sim["order"], sim["ticks"], params)
        return self._plans[key]

    def _run_task(self, task, micros, m, scaler, zb, state, chunk_params,
                  received=None):
        """Run one F, B or W task; returns what it sends on (an F's
        output, a B's input gradient), or None."""
        acts, seeds, pending_w, losses = state
        key = (task.micro, task.chunk)
        last = self._layers.num_chunks - 1
        micro = micros[task.micro]
        if task.kind == "F":
            if task.chunk == 0:
                x, xin = micro[0], None
            else:
                prev = received.pop(key) if received is not None \
                    else acts[(task.micro, task.chunk - 1)][1]
                xin = prev.detach().requires_grad_(
                    prev.is_floating_point())
                x = xin
            out = self._layers.forward_chunk(x, task.chunk)
            if task.chunk == last:
                out = self._last_output(out, micro, m, scaler)
                losses[task.micro] = out
            acts[key] = (xin, out)
            return None if task.chunk == last else out
        if task.kind == "B":
            xin, out = acts.pop(key)
            seed = seeds.pop(key, None)
            inputs = [] if xin is None or not xin.requires_grad else [xin]
            if zb:
                params = [p for p in chunk_params[task.chunk]
                          if p.requires_grad]
                grads = torch.autograd.grad(
                    [out], inputs + params,
                    None if seed is None else [seed], allow_unused=True)
                gin = grads[0] if inputs else None
                pending_w[key] = list(zip(params, grads[len(inputs):]))
            else:
                torch.autograd.backward(
                    [out], None if seed is None else [seed])
                gin = xin.grad if inputs else None
            if gin is not None and received is None:
                seeds[(task.micro, task.chunk - 1)] = gin    # in process
            return gin
        for p, g in pending_w.pop(key, ()):        # W
            _accumulate(p, g)
        return None

    def _run_task_schedule(self, micros, scaler, mode):
        """VPP / ZBH1 in one process: ``simulate``'s global order, chunk by
        chunk."""
        m = len(micros)
        order, _, chunk_params = self._plan(mode, m)
        state = ({}, {}, {}, [None] * m)
        for _stage, task in order:
            self._run_task(task, micros, m, scaler, mode in _ZB_MODES, state,
                           chunk_params)
        total = torch.stack([loss.detach() for loss in state[3]]).sum()
        if scaler is not None:
            total = total * (1.0 / scaler._scale)
        return total

    # ------------------------------------------------------------------
    def _exchanger(self):
        if self._exchange is None:
            hcg = self._layers._hcg
            dev = next(iter(self._layers.parameters()),
                       torch.empty(0)).device
            self._exchange = _Exchange(hcg.get_pipe_parallel_group(), dev)
        return self._exchange

    def _run_over_ranks(self, micros, scaler, mode, forward_only=False):
        """Every schedule over the pipeline group (module docstring):
        ``simulate``'s tick table in lockstep, each tick's transfers
        between neighbours posted together."""
        m = len(micros)
        _, ticks, chunk_params = self._plan(mode, m, forward_only)
        ex = self._exchanger()
        stage, S = self._layers.stage, self.num_stages
        last = self._layers.num_chunks - 1
        state = ({}, {}, {}, [None] * m)
        acts_in = {}
        zb = mode in _ZB_MODES
        for assign in ticks:
            task = assign.get(stage)
            sent = None if task is None else self._run_task(
                task, micros, m, scaler, zb, state, chunk_params,
                received=acts_in)
            transfers = _transfers(assign, S, last)
            if not transfers:
                continue
            got = ex.run(stage, sent if stage in transfers else None,
                         transfers)
            for s, x in got.items():
                t = assign[s]
                if t.kind == "F":
                    acts_in[(t.micro, t.chunk + 1)] = x
                else:
                    state[1][(t.micro, t.chunk - 1)] = x
        own = [loss.detach() for loss in state[3] if loss is not None]
        total = torch.stack(own).sum() if own else torch.zeros(
            (), device=ex.device)
        if scaler is not None and not forward_only:
            total = total * (1.0 / scaler._scale)
        from ...communication import all_reduce

        total = total.float()
        all_reduce(total, group=ex.group)
        if not forward_only:
            self._layers.allreduce_shared_weight_gradients()
        return total

    # ------------------------------------------------------------------
    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """The schedule over one batch, then the optimizer's step."""
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The mean loss over the batch's micro-batches, without
        gradients."""
        self._layers.eval()
        micros = self._split_micro(data)
        with torch.no_grad():
            if self._layers.stage is not None:
                return self._run_over_ranks(micros, None,
                                            _mode(self.schedule_mode),
                                            forward_only=True)
            losses = [self._forward_micro(micro) for micro in micros]
        return torch.stack(losses).sum() * (1.0 / len(losses))

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)
