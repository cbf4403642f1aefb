"""``Engine``: ``fit`` / ``evaluate`` / ``predict`` over a ``DistModel``.

Counterpart of ``paddle_tpu/distributed/auto_parallel/engine.py``. With
a manual plan (the model sharded by ``shard_layer`` / ``shard_tensor`` or
a shard plan) the engine uses that mesh; with none it replicates the
model over a ``dp`` mesh of every rank, so each batch is sharded over
the ranks (the reference's default data-parallel layout). Data is a
``torch.utils.data`` ``DataLoader`` or ``Dataset``, or any iterable of
batches; its tensors are laid out by ``shard_dataloader`` on the dp
axis.

``prepare``'s automatic plan (the reference's cost-model search, and
``completion.derive_shard_plan`` for a family without a plan) reads a
captured static ``Program``, which the port has not yet: it raises,
naming ROADMAP queue A item 7.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .api import DistParameter, shard_dataloader, shard_layer
from .dist_model import DistModel
from .placement import ProcessMesh

__all__ = ["Engine"]


class Engine:
    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 cluster=None, strategy=None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics if isinstance(metrics, (list, tuple)) \
            else ([metrics] if metrics is not None else [])
        self._strategy = strategy
        self._dist_model: Optional[DistModel] = None
        self._mesh: Optional[ProcessMesh] = None

    def prepare(self, inputs_spec=None, labels_spec=None, main_program=None,
                startup_program=None, mode="train", init_parameters=True,
                global_batch_size=None, sequence_length=None):
        """The automatic plan: ROADMAP queue A item 7 (module
        docstring)."""
        raise NotImplementedError(
            "Engine.prepare: the automatic parallel plan reads a captured "
            "static Program (completion.py), which comes with ROADMAP.md "
            "queue A item 7; shard the model by hand (shard_layer, "
            "shard_tensor or a model's shard plan) and call fit")

    def _ensure_mesh(self):
        if self._mesh is not None:
            return self._mesh
        for p in self._model.parameters():
            if isinstance(p, DistParameter):
                self._mesh = p.process_mesh
                return self._mesh
        from .. import env

        self._mesh = ProcessMesh(np.arange(env.get_world_size()), ["dp"])
        shard_layer(self._model, self._mesh)
        return self._mesh

    def _ensure_dist_model(self):
        if self._dist_model is None:
            self._ensure_mesh()
            self._dist_model = DistModel(
                self._model, loss=self._loss, optimizer=self._optimizer,
                strategy=self._strategy)
        return self._dist_model

    def fit(self, train_data, epochs: int = 1,
            batch_size: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, valid_data=None,
            log_freq: int = 10, verbose: int = 1, callbacks=None):
        dm = self._ensure_dist_model().train()
        loader = self._wrap_loader(train_data, batch_size)
        history = {"loss": []}
        for epoch in range(epochs):
            losses = []
            for step, batch in enumerate(loader):
                if steps_per_epoch is not None and step >= steps_per_epoch:
                    break
                losses.append(float(dm(*self._as_args(batch))))
                if verbose and log_freq and step % log_freq == 0:
                    print(f"epoch {epoch} step {step}: loss {losses[-1]:.4f}")
            history["loss"].append(
                float(np.mean(losses)) if losses else float("nan"))
            if valid_data is not None:
                self.evaluate(valid_data, batch_size=batch_size,
                              verbose=verbose)
            dm.train()
        return history

    def evaluate(self, valid_data, batch_size: Optional[int] = None,
                 steps: Optional[int] = None, log_freq: int = 10,
                 verbose: int = 1, callbacks=None):
        dm = self._ensure_dist_model().eval()
        loader = self._wrap_loader(valid_data, batch_size)
        losses = []
        for step, batch in enumerate(loader):
            if steps is not None and step >= steps:
                break
            losses.append(float(dm(*self._as_args(batch))))
        result = {"loss": float(np.mean(losses)) if losses else float("nan")}
        if verbose:
            print(f"eval: {result}")
        return result

    def predict(self, test_data, batch_size: Optional[int] = None,
                steps: Optional[int] = None, callbacks=None):
        dm = self._ensure_dist_model().predict()
        loader = self._wrap_loader(test_data, batch_size)
        outputs = []
        fwd_arity = self._forward_arity()
        for step, batch in enumerate(loader):
            if steps is not None and step >= steps:
                break
            args = self._as_args(batch)
            # drop trailing labels the forward cannot take
            if self._loss is not None and fwd_arity is not None and \
                    len(args) > fwd_arity:
                args = args[:fwd_arity]
            outputs.append(dm(*args))
        return outputs

    def _forward_arity(self):
        """Positional-arg count of model.forward, or None if varargs."""
        import inspect

        try:
            sig = inspect.signature(self._model.forward)
        except (TypeError, ValueError):
            return None
        count = 0
        for p in sig.parameters.values():
            if p.kind == inspect.Parameter.VAR_POSITIONAL:
                return None
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD):
                count += 1
        return count

    def _wrap_loader(self, data, batch_size):
        from torch.utils.data import DataLoader, Dataset

        if isinstance(data, Dataset):
            data = DataLoader(data, batch_size=batch_size or 1,
                              shuffle=False)
        mesh = self._ensure_mesh()
        dp_axis = "dp" if "dp" in mesh.dim_names else mesh.dim_names[0]
        return shard_dataloader(data, mesh, shard_dims=dp_axis)

    @staticmethod
    def _as_args(batch):
        if isinstance(batch, (list, tuple)):
            return tuple(batch)
        return (batch,)
