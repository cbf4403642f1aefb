"""``DataParallel``.

Counterpart of ``paddle_tpu/distributed/parallel_wrapper.py``. The
reference shards the batch over a ``dp`` mesh axis inside one process
and leaves the gradient all-reduce to XLA. Here each rank is a process
fed its own share of the batch, and the wrapper makes every rank's
gradients the mean over the ranks of their gradients: the full batch's,
when each rank's loss is a mean over equal shares.

- At construction the parameters and persistent buffers are broadcast
  from the group's first rank, so every rank starts from one state (the
  reference's replicated parameters are equal by construction).
- The gradients are reduced in buckets, as Paddle's ``EagerReducer``
  does: the parameters in reverse order (the order backward finishes
  them), grouped by dtype and device, the first bucket up to
  ``last_comm_buffer_size_MB`` and the rest up to
  ``comm_buffer_size_MB``. Each bucket is one flat buffer; a parameter's
  gradient becomes a view of it (``p.grad`` is that view after
  backward). A post-accumulate-grad hook copies a fresh gradient into
  its view (none to copy when the gradient was kept, ``clear_grad(
  set_to_zero=True)``); when a bucket is full its ``all_reduce(AVG)``
  starts, asynchronously, buckets in order on every rank, while
  backward goes on. A callback at the end of backward starts what is
  left and waits for all (on the card: the current stream waits), so
  ``optimizer.step()`` sees averaged gradients without a call from the
  user.
- Under ``jit.to_static`` the hooks, the collectives and the wait are
  captured with the step (NCCL). A step that cannot be captured raises
  ``jit.CaptureError`` with the reason instead of running eagerly.
- ``find_unused_parameters=True``: a parameter that got no gradient in
  a backward joins its bucket with zeros (its ``grad`` the zero view);
  without it such a backward raises, as a reducer waiting for that
  gradient would hang.
- Before ``init_parallel_env`` (no process group) the wrapper reduces
  nothing: a one-rank world's mean is its gradient.

``mesh=`` (a data-parallel mesh axis in one process) waits for ROADMAP
queue A item 4 (b). ``strategy`` is accepted as the reference accepts
it. ``state_dict``, ``set_state_dict``, ``parameters`` and
``named_parameters`` are the wrapped layer's; ``scale_loss`` is the
identity and ``apply_collective_grads`` does nothing, as there.
"""
from __future__ import annotations

from typing import List

import torch

from .communication import ReduceOp, all_reduce, broadcast, get_group

__all__ = ["DataParallel"]

_MB = 1 << 20


class _Bucket:
    __slots__ = ("params", "flat", "views", "fired", "pending", "task")

    def __init__(self, params: List[torch.nn.Parameter]):
        self.params = params
        p0 = params[0]
        n = sum(p.numel() for p in params)
        self.flat = torch.zeros(n, dtype=p0.dtype, device=p0.device)
        self.views, off = [], 0
        for p in params:
            self.views.append(self.flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        self.fired = [False] * len(params)
        self.pending = len(params)
        self.task = None

    @property
    def nbytes(self) -> int:
        return self.flat.numel() * self.flat.element_size()


class _Reducer:
    """The bucketed gradient all-reduce (module docstring)."""

    def __init__(self, params, group, bucket_bytes, first_bucket_bytes,
                 find_unused_parameters):
        self.group = group
        self.find_unused = find_unused_parameters
        self.buckets: List[_Bucket] = []
        self._where = {}
        seen, order = set(), []
        for p in params:
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                order.append(p)
        open_: dict = {}        # (dtype, device) -> [params, bytes, cap]
        for p in reversed(order):
            cur = open_.setdefault((p.dtype, p.device),
                                   [[], 0, first_bucket_bytes])
            size = p.numel() * p.element_size()
            if cur[0] and cur[1] + size > cur[2]:
                self._close(cur[0])
                cur[:] = [[], 0, bucket_bytes]
            cur[0].append(p)
            cur[1] += size
        for params, _, _ in open_.values():
            self._close(params)
        self._next = 0
        self._armed = False
        self._hooks = [p.register_post_accumulate_grad_hook(self._hook)
                       for b in self.buckets for p in b.params]

    def _close(self, params):
        bi = len(self.buckets)
        self.buckets.append(_Bucket(params))
        for i, p in enumerate(params):
            self._where[id(p)] = (bi, i)

    def _hook(self, p):
        if not self._armed:
            self._armed = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        bi, i = self._where[id(p)]
        b = self.buckets[bi]
        view = b.views[i]
        if p.grad.data_ptr() != view.data_ptr():
            with torch.no_grad():
                view.copy_(p.grad)
            p.grad = view
        if not b.fired[i]:
            b.fired[i] = True
            b.pending -= 1
        while self._next < len(self.buckets) \
                and self.buckets[self._next].pending == 0:
            self._launch(self.buckets[self._next])
            self._next += 1

    def _launch(self, b):
        from ..jit._capture import CaptureError, is_capturing

        if is_capturing() and b.flat.is_cuda \
                and self.group.process_group is not None:
            from .communication.group import get_backend

            backend = get_backend(self.group)
            if backend != "nccl":
                raise CaptureError(
                    f"DataParallel: a {backend} all-reduce of CUDA "
                    f"gradients cannot be captured in a CUDA graph (NCCL "
                    f"can); run the step outside jit.to_static")
        b.task = all_reduce(b.flat, op=ReduceOp.AVG, group=self.group,
                            sync_op=False)

    def _finish(self):
        try:
            for b in self.buckets[self._next:]:
                missing = [p for p, f in zip(b.params, b.fired) if not f]
                if missing and not self.find_unused:
                    raise RuntimeError(
                        f"DataParallel: {len(missing)} parameter(s) got no "
                        f"gradient in this backward, so their bucket "
                        f"could not be reduced; pass "
                        f"find_unused_parameters=True")
                with torch.no_grad():
                    for i, p in enumerate(b.params):
                        if not b.fired[i]:
                            b.views[i].zero_()
                            p.grad = b.views[i]
                self._launch(b)
            for b in self.buckets:
                b.task.wait()
        finally:
            for b in self.buckets:
                b.fired = [False] * len(b.params)
                b.pending = len(b.params)
                b.task = None
            self._next = 0
            self._armed = False


class DataParallel(torch.nn.Module):
    """``paddle.DataParallel(layers)`` (module docstring)."""

    def __init__(self, layers: torch.nn.Module, strategy=None,
                 comm_buffer_size_MB: int = 25,
                 last_comm_buffer_size_MB: int = 1,
                 find_unused_parameters=False, group=None, mesh=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "DataParallel(mesh=...): data parallelism over a mesh axis "
                "comes with placements (ROADMAP.md queue A item 4 (b)); one "
                "process a rank needs no mesh")
        self._layers = layers
        self._strategy = strategy
        self.find_unused_parameters = find_unused_parameters
        self._group = group if group is not None else get_group(0)
        self._reducer = None
        if self._group.process_group is not None:
            self._sync_params_and_buffers()
            self._reducer = _Reducer(
                layers.parameters(), self._group,
                int(comm_buffer_size_MB * _MB),
                int(last_comm_buffer_size_MB * _MB), find_unused_parameters)

    def _sync_params_and_buffers(self):
        src = self._group.ranks[0]
        with torch.no_grad():
            for p in self._layers.parameters():
                broadcast(p.data, src=src, group=self._group)
            for m in self._layers.modules():
                for name, buf in m._buffers.items():
                    if buf is not None \
                            and name not in m._non_persistent_buffers_set:
                        broadcast(buf, src=src, group=self._group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @property
    def buckets(self):
        """The reducer's buckets as (dtype, parameters, bytes), in launch
        order (empty without a process group)."""
        if self._reducer is None:
            return []
        return [(b.flat.dtype, len(b.params), b.nbytes)
                for b in self._reducer.buckets]

    # passthrough surface, as the reference's
    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        fn = getattr(self._layers, "set_state_dict",
                     self._layers.load_state_dict)
        return fn(*a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass
