"""``DistModel`` and ``to_static``: a layer, its loss and its optimizer
run as one step per mode (train, eval, predict).

Counterpart of ``paddle_tpu/distributed/auto_parallel/dist_model.py``
(Paddle's ``api.py`` ``DistModel`` and ``to_static``). Each mode's step
goes through the port's ``jit.to_static`` (a CUDA graph on the card,
eager on the CPU), as the reference's goes through its ``jit``. The
layer's placements come from ``shard_layer`` / ``shard_tensor`` (or a
model's shard plan): inputs that are ``DTensor``\\ s compute under torch's
sharding propagation, whose backward reduces each replicated
parameter's gradient over the axes its inputs were sharded on, so no
partition pass is needed, as GSPMD needs none in the reference. A loss
or output that is a ``DTensor`` is returned whole (``full_tensor``).
``strategy.sharding`` applies ``shard_optimizer`` at its stage (1 to 3):
at stage 3 the parameters whose dim 0 the ``dp`` axis divides are
sharded between steps, and each module all-gathers its own for its
forward (``api.ShardingStage3``).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["DistModel", "to_static"]


def _whole(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.full_tensor()
    if isinstance(x, (list, tuple)):
        return type(x)(_whole(v) for v in x)
    return x


def _mesh_of(layer):
    """The mesh of ``layer``'s first sharded parameter (None when none
    is)."""
    from .api import DistParameter

    for p in layer.parameters():
        if isinstance(p, DistParameter):
            return p.process_mesh
    return None


def _load_param(p, value):
    """Give parameter ``p`` the whole tensor or ``DTensor`` ``value``
    (its shard when ``p`` is sharded)."""
    from torch.distributed.tensor import DTensor

    from .api import DistParameter, _local_shard

    if isinstance(value, DTensor):
        value = value.full_tensor()
    value = torch.as_tensor(value).to(device=p.device, dtype=p.dtype)
    with torch.no_grad():
        if isinstance(p, DistParameter):
            value = _local_shard(value, p.device_mesh, p.torch_placements)
        p.copy_(value)


class DistModel:
    """The step of the current mode: ``__call__`` runs the train step
    (forward, loss, backward, optimizer step) and returns the loss, the
    eval step's loss, or the predict step's outputs."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, metrics=None):
        from ... import jit

        self.network = layer
        self._loss_fn = loss
        self._optimizer = optimizer
        self._strategy = strategy
        self._mode: Optional[str] = None
        self._loader = loader
        mesh = _mesh_of(layer)
        if mesh is not None:
            from .api import compute_on_dtensors

            compute_on_dtensors(layer, mesh)

        if strategy is not None and optimizer is not None and \
                getattr(strategy, "sharding", None) is not None and \
                strategy.sharding.enable:
            from .api import (ShardingStage1, ShardingStage2,
                              ShardingStage3, shard_optimizer)

            stage_cls = {1: ShardingStage1, 2: ShardingStage2,
                         3: ShardingStage3}[strategy.sharding.stage]
            self._optimizer = shard_optimizer(optimizer, stage_cls())

        def _forward_loss(*args):
            if self._loss_fn is None:
                return self.network(*args)
            *inputs, labels = args
            return self._loss_fn(self.network(*inputs), labels)

        @jit.to_static
        def _train_step(*args):
            loss = _forward_loss(*args)
            loss.backward()
            self._optimizer.step()
            self._optimizer.clear_grad()
            return _whole(loss.detach())

        @jit.to_static
        def _eval_step(*args):
            with torch.no_grad():
                return _whole(_forward_loss(*args))

        @jit.to_static
        def _predict_step(*args):
            with torch.no_grad():
                return _whole(self.network(*args))

        self._train_step = _train_step
        self._eval_step = _eval_step
        self._predict_step = _predict_step

        if optimizer is not None and loss is not None:
            self.train()
        elif loss is not None:
            self.eval()
        else:
            self.predict()

    def train(self):
        self._mode = "train"
        self.network.train()
        return self

    def eval(self):
        self._mode = "eval"
        self.network.eval()
        return self

    def predict(self):
        self._mode = "predict"
        self.network.eval()
        return self

    @property
    def mode(self):
        return self._mode

    def __call__(self, *args):
        if self._mode == "train":
            if self._optimizer is None or self._loss_fn is None:
                raise ValueError(
                    "DistModel needs loss and optimizer for train mode")
            return self._train_step(*args)
        if self._mode == "eval":
            if self._loss_fn is None:
                raise ValueError("DistModel needs loss for eval mode")
            return self._eval_step(*args)
        return self._predict_step(*args)

    def state_dict(self, mode: str = "all"):
        """Parameters (a sharded one as its ``DTensor``) and, under
        ``opt.``, the optimizer's state."""
        from .api import DistParameter

        state = {}
        if mode in ("all", "param"):
            for name, p in self.network.named_parameters():
                state[name] = (p.as_dtensor().detach()
                               if isinstance(p, DistParameter) else p.detach())
        if mode in ("all", "opt") and self._optimizer is not None:
            state.update({f"opt.{k}": v for k, v in
                          self._optimizer.state_dict().items()})
        return state

    def set_state_dict(self, state_dict):
        params = dict(self.network.named_parameters())
        opt_state = {}
        for k, v in state_dict.items():
            if k.startswith("opt."):
                opt_state[k[len("opt."):]] = v
            elif k in params:
                _load_param(params[k], v)
        if opt_state and self._optimizer is not None:
            self._optimizer.set_state_dict(opt_state)

    def dist_main_program(self, mode=None):
        """The reference returns its partitioned program; the port has no
        static program (ROADMAP queue A item 7)."""
        raise NotImplementedError(
            "DistModel.dist_main_program: the port has no static Program "
            "(ROADMAP.md queue A item 7)")


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              metrics=None) -> DistModel:
    """A :class:`DistModel` over ``layer``."""
    return DistModel(layer, loader=loader, loss=loss, optimizer=optimizer,
                     strategy=strategy, metrics=metrics)
