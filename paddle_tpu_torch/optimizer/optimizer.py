"""Optimizer base.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: the paddle API
(``parameters=`` as a list or as groups, a float ``learning_rate``,
``weight_decay``, ``multi_precision``, ``step()``, ``clear_grad()``,
``state_dict()`` / ``set_state_dict()``). Accumulators are fp32; with
``multi_precision`` a bf16 or fp16 parameter keeps an fp32 master copy,
the update runs on the master and the parameter receives its cast. The
reference's update is plain ``jnp`` with no kernel, so here it is plain
torch ops under ``no_grad``, updating the master, the accumulators and
the parameter in place (JAX rebuilds them; in place saves memory).

Not ported yet, and refused rather than ignored: learning-rate
schedulers (``optimizer/lr.py``), ``grad_clip``, and keys of a parameter
group other than ``params``; they come with the slice that ports
``optimizer/lr.py`` and ``nn/clip.py`` (``ROADMAP.md`` queue A).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

__all__ = ["Optimizer"]


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the slice that ports "
        f"optimizer/lr.py and nn/clip.py (ROADMAP.md queue A)")


class Optimizer:
    #: accumulator names of the subclass, each an fp32 tensor per parameter
    _accum_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (dygraph-style optimizer)")
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float)):
            raise _later("a learning-rate scheduler")
        if grad_clip is not None:
            raise _later("grad_clip")
        params: List[torch.Tensor] = []
        for item in parameters:
            if isinstance(item, dict):
                extra = sorted(set(item) - {"params"})
                if extra:
                    raise _later(f"parameter-group options {extra}")
                params.extend(item["params"])
            else:
                params.append(item)
        self._parameter_list = params
        self._learning_rate = float(learning_rate)
        # a float weight_decay is L2 decay added to the gradient
        # (the reference's L2Decay)
        self._l2_coeff = (None if weight_decay is None
                          else float(weight_decay))
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {
            n: {} for n in self._accum_names}
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0

    # ------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def _accum(self, name: str, p: torch.Tensor) -> torch.Tensor:
        store = self._accumulators[name]
        if id(p) not in store:
            store[id(p)] = torch.zeros_like(p, dtype=torch.float32)
        return store[id(p)]

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
        lr = self.get_lr()
        for p in self._parameter_list:
            if not p.requires_grad or p.grad is None:
                continue
            g = p.grad
            if self._l2_coeff is not None:
                g = g + self._l2_coeff * p.to(g.dtype)
            self._update_param(p, g, lr)
        self._step_count += 1

    def _update_param(self, p: torch.Tensor, grad: torch.Tensor, lr: float):
        raise NotImplementedError

    @staticmethod
    def _fp32(p: torch.Tensor, master):
        """The fp32 tensor an update works on in place: the master, p
        itself when it is fp32, else an fp32 copy of p."""
        if master is not None:
            return master
        return p if p.dtype == torch.float32 else p.float()

    @staticmethod
    def _write_back(p: torch.Tensor, p32: torch.Tensor, master):
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

    # ------------------------------------------------------------------
    def _names(self) -> Dict[int, str]:
        return {id(p): f"param_{i}" for i, p in enumerate(self._parameter_list)}

    def state_dict(self) -> Dict[str, Any]:
        """Accumulators and master weights keyed ``param_<i>__<name>`` (i
        the parameter's position), and ``__step__``."""
        names = self._names()
        sd: Dict[str, Any] = {}
        for accum, store in self._accumulators.items():
            for pid, t in store.items():
                sd[f"{names[pid]}__{accum}"] = t
        for pid, t in self._master_weights.items():
            sd[f"{names[pid]}__master"] = t
        sd["__step__"] = self._step_count
        return sd

    def set_state_dict(self, state_dict: Dict[str, Any]):
        by_name = {n: pid for pid, n in self._names().items()}
        params = {id(p): p for p in self._parameter_list}
        for key, value in state_dict.items():
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
