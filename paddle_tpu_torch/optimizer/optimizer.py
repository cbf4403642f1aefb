"""Optimizer base.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: the paddle API
(``parameters=`` as a list or as groups, a float or an ``LRScheduler`` as
``learning_rate``, ``weight_decay`` as a number (L2) or a regularizer,
``grad_clip``, ``multi_precision``, ``step()`` / ``minimize()``,
``clear_grad()``, ``set_lr`` / ``set_lr_scheduler``, ``state_dict()`` /
``set_state_dict()``).

A step: the ``(param, grad)`` pairs of the parameters that require a
gradient go through ``grad_clip``; each gradient then gets its
regularizer (the parameter's own ``regularizer`` when it carries one,
else the optimizer's ``weight_decay``); each parameter's rate is
``get_lr()`` times ``p.optimize_attr["learning_rate"]`` where the
parameter carries that dict; then the subclass updates every parameter
that has a gradient (``_update``; per parameter by default, Adam and
AdamW in multi-tensor ops). Accumulators are fp32; with
``multi_precision`` a bf16/fp16 parameter keeps an fp32 master copy, the
update runs on it and the parameter receives its cast. The reference's
update is plain ``jnp``, so here it is plain torch under ``no_grad``, in
place on the masters, accumulators and parameters (JAX rebuilds them).

Names. ``parameters`` may hold ``(name, param)`` pairs, as
``model.named_parameters()`` yields them: torch's ``Tensor.name`` is
read-only, so a torch parameter cannot carry a name the way a reference
``Parameter`` does. A parameter's name is the one it came with, else its
``name`` attribute when set, else ``param_<i>`` by position (the
reference's ``p.name or f"param_{i}"``). ``state_dict`` keys and AdamW's
``apply_decay_param_fun`` see that one name.

Sharded parameters. A ``distributed.DistParameter`` (tensor parallel, or
ZeRO-3) is this rank's shard, so its update and its states are the
shard's. After ``distributed.shard_optimizer`` at stage 1 or 2
(``_row_shards``) a parameter sharded over the data-parallel axis is
updated in this rank's rows only, with states of those rows, and the
rows are all-gathered after the step (``restore_param_layouts``); at
stages 2 and 3 the step first averages the gradients over that axis
(``_RowShards.reduce``: a reduce-scatter for the rows), before the
clip.

Groups. As in the reference, a group's keys other than ``params`` are
stored in ``_param_groups`` and never read: they change nothing.

Capture (``jit.to_static``), the counterpart of the reference's
``_lr_override``, ``_step_override`` and ``_ensure_accumulators``: a
captured step may not read its rate or step count on the host, where a
replay would find the values of the capture. So ``to_static`` sets
``_lr_override`` and ``_step_override`` to 0-dim fp32 device tensors
that it fills before every replay (the rate, and the 1-based step count
``_step_count + 1``), and the update reads them through :meth:`_lr_now`
and :meth:`_t`. With them, scalars that hang on the rate or the step
(the bias corrections, RAdam's rectification, NAdam's schedule, ASGD's
window slot) are fp32 device tensors, computed on the device as the
reference's traced step computes them; without them (eager) they are the
host numbers they were. ``to_static`` makes every accumulator and master
exist before it captures (:meth:`_ensure_accumulators`), and replays the
``_step_count`` increments of the captured step on the host.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..regularizer import L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer"]


def _named(items) -> list:
    """``(name or None, param)`` for params or ``(name, param)`` pairs."""
    return [item if isinstance(item, tuple) and len(item) == 2
            and isinstance(item[0], str) else (None, item) for item in items]


def _one_minus(beta) -> float:
    """``1 - beta`` in fp32, as the reference computes it from its fp32
    hyperparameters."""
    return float(np.float32(1) - np.float32(beta))


def _bias_correction(beta, t):
    """``1 - beta ** t`` in fp32, as the reference computes it from its
    fp32 step count: a float for a host ``t``, an fp32 device tensor for
    a device ``t`` (a captured step)."""
    if isinstance(t, torch.Tensor):
        return 1.0 - torch.pow(float(np.float32(beta)), t)
    return float(np.float32(1) - np.float32(beta) ** np.float32(t))


class Optimizer:
    #: accumulator names of the subclass, each an fp32 tensor per parameter
    _accum_names: tuple = ()
    #: an accumulator's first value where it is not 0
    _accum_fills: dict = {}

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (dygraph-style optimizer)")
        items = list(parameters)
        named: list = []
        self._param_groups: List[Dict[str, Any]] = []
        if items and isinstance(items[0], dict):
            for group in items:
                entries = _named(group["params"])
                named.extend(entries)
                self._param_groups.append(
                    {**group, "params": [p for _, p in entries]})
        else:
            named = _named(items)
            self._param_groups.append({"params": [p for _, p in named]})
        self._parameter_list = [p for _, p in named]
        self._param_names = [
            n or getattr(p, "name", None) or f"param_{i}"
            for i, (n, p) in enumerate(named)]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (int, float)):
            self.regularization = L2Decay(float(weight_decay))
        else:
            self.regularization = weight_decay
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {
            n: {} for n in self._accum_names}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0
        # device scalars of a captured step (see the module docstring)
        self._lr_override = None
        self._step_override = None

    # ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def _lr_now(self):
        """The rate of this step: ``get_lr()``, or the device scalar a
        captured step reads."""
        return self.get_lr() if self._lr_override is None else \
            self._lr_override

    def _t(self):
        """The 1-based step count of this step (a device scalar in a
        captured step)."""
        return self._step_count + 1 if self._step_override is None else \
            self._step_override

    def set_lr(self, value: float):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _accum(self, name: str, p: torch.Tensor, fill: float = 0.0):
        store = self._accumulators[name]
        if id(p) not in store:
            store[id(p)] = torch.full_like(p, fill, dtype=torch.float32)
        return store[id(p)]

    def _accum_fill(self, name: str) -> float:
        return self._accum_fills.get(name, 0.0)

    def _ensure_accumulators(self):
        """Make every accumulator and master weight a step would make, for
        every parameter that takes gradients (a capture must find them)."""
        rows = getattr(self, "_row_shards", None)
        for p in self._parameter_list:
            if p.requires_grad:
                if rows is not None and id(p) in rows.views:
                    p = rows.views[id(p)][1]
                self._master(p)
                for name in self._accum_names:
                    self._accum(name, p, self._accum_fill(name))

    def _master(self, p: torch.Tensor):
        """The fp32 master copy of a low-precision parameter (None for an
        fp32 parameter or without ``multi_precision``)."""
        if not self._multi_precision or p.dtype == torch.float32:
            return None
        if id(p) not in self._master_weights:
            self._master_weights[id(p)] = p.detach().float()
        return self._master_weights[id(p)]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad]
        rows = getattr(self, "_row_shards", None)
        if rows is not None and rows.stage > 1:
            params_grads = rows.reduce(params_grads)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params_grads = [(p, g) for p, g in params_grads if g is not None]
        if rows is not None and rows.stage == 1:
            params_grads = rows.slice(params_grads)
        if params_grads:
            lr = self._lr_now()
            params = [p for p, _ in params_grads]
            ratios = [getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0) for p in params]
            lrs = [lr if r == 1.0 and isinstance(lr, torch.Tensor)
                   else lr * r for r in ratios]
            self._update(params, self._regularized(params_grads), lrs)
        self._step_count += 1
        if rows is not None:
            from ..distributed.auto_parallel.api import restore_param_layouts

            restore_param_layouts(self)

    minimize_step = step

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, None

    def _regularized(self, params_grads):
        """The gradients with their regularizers added, one multi-tensor
        op per regularizer."""
        grads = [g for _, g in params_grads]
        by_reg: Dict[int, tuple] = {}
        for i, (p, _) in enumerate(params_grads):
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                by_reg.setdefault(id(reg), (reg, []))[1].append(i)
        for reg, idx in by_reg.values():
            new = reg._apply([params_grads[i][0] for i in idx],
                             [grads[i] for i in idx])
            for i, g in zip(idx, new):
                grads[i] = g
        return grads

    def _update(self, params, grads, lrs):
        for p, g, lr in zip(params, grads, lrs):
            self._update_param(p, g, lr)

    def _update_param(self, p: torch.Tensor, grad: torch.Tensor, lr: float):
        raise NotImplementedError

    def _fp32(self, p: torch.Tensor):
        """The fp32 tensor a per-parameter update works on in place: the
        master, p itself when it is fp32, else an fp32 copy of p."""
        master = self._master(p)
        return master if master is not None else p.float()

    @staticmethod
    def _write_back(p: torch.Tensor, p32: torch.Tensor):
        """After an in-place update of ``p32`` (from :meth:`_fp32`), give
        p its value, cast to p's dtype."""
        if p32 is not p:
            p.copy_(p32)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # ------------------------------------------------------------------
    def _names(self) -> Dict[int, str]:
        names = {id(p): n for p, n in zip(self._parameter_list,
                                          self._param_names)}
        rows = getattr(self, "_row_shards", None)
        if rows is not None:
            for pid, (_, view) in rows.views.items():
                names[id(view)] = names[pid]
        return names

    def state_dict(self) -> Dict[str, Any]:
        """Accumulators and master weights keyed ``<name>__<accumulator>``
        (the parameter's name, see the module docstring), the scheduler's
        state under ``LR_Scheduler`` and the step count under
        ``__step__``."""
        names = self._names()
        sd: Dict[str, Any] = {}
        for accum, store in self._accumulators.items():
            for pid, t in store.items():
                sd[f"{names[pid]}__{accum}"] = t
        for pid, t in self._master_weights.items():
            sd[f"{names[pid]}__master"] = t
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["__step__"] = self._step_count
        return sd

    def set_state_dict(self, state_dict: Dict[str, Any]):
        by_name = {n: pid for pid, n in self._names().items()}
        params = {id(p): p for p in self._parameter_list}
        rows = getattr(self, "_row_shards", None)
        if rows is not None:
            params.update({id(v): v for _, v in rows.views.values()})
        for key, value in state_dict.items():
            if key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(value)
                continue
            if key == "__step__":
                self._step_count = int(value)
                continue
            pname, _, accum = key.rpartition("__")
            pid = by_name.get(pname)
            if pid is None:
                continue
            t = torch.as_tensor(value, dtype=torch.float32,
                                device=params[pid].device).clone()
            if accum == "master":
                self._master_weights[pid] = t
            elif accum in self._accumulators:
                self._accumulators[accum][pid] = t
            else:
                raise KeyError(f"set_state_dict: unknown entry {key!r}")

    load_state_dict = set_state_dict
