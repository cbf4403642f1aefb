"""Automatic mixed precision.

Counterpart of ``paddle_tpu/amp/__init__.py``: ``auto_cast`` /
``amp_guard``, ``decorate``, ``GradScaler``, ``is_bfloat16_supported``
and ``is_float16_supported``. The op-level debugging tools of
``amp/debugging.py`` are not ported yet (``ROADMAP.md`` queue A).

``auto_cast`` is ``torch.autocast`` in the amp dtype (bf16 by default,
fp16 on request) on the CPU and, where a card is visible, on CUDA, so
the tensors' own device decides which region applies. Levels O1 and O2
both map onto it; O2's half model comes from ``decorate``. The
reference's white list (matmul, linear, attention) is torch's
lower-precision list plus the port's own white-list entry points and
Functions (``core/autocast.py``); its black-list ops run in the dtype
they get. One difference: torch autocast on CUDA also computes its
fp32-list ops (softmax, log_softmax, the norms) in fp32 where the
reference leaves them in whatever dtype they get. The custom white and
black lists name the reference's primitives, which the port does not
have: they raise.

``GradScaler`` is the reference's dynamic loss scaling step for step,
``step()`` calling ``update()`` itself as there (so a caller's
``scaler.step(o); scaler.update()`` counts a step twice in both
packages). The unscale and the finiteness check are multi-tensor ops
and the skip decision reads one flag back to the host a step (the
reference reads one per parameter). That read is why ``step()`` cannot
run inside ``jit.to_static``: it raises ``jit.CaptureError`` there, the
counterpart of the reference's failed trace.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..jit._capture import no_host_read

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported"]


def _half(dtype) -> torch.dtype:
    return (torch.float16 if dtype in ("float16", "fp16", torch.float16)
            else torch.bfloat16)


class auto_cast:
    """``paddle.amp.auto_cast``: a ``torch.autocast`` region in ``dtype``
    on the CPU and, with a card, on CUDA; ``enable=False`` turns
    autocast off inside it."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if custom_white_list or custom_black_list:
            raise NotImplementedError(
                "auto_cast: custom_white_list / custom_black_list name the "
                "reference's primitives, which the port does not have; "
                "torch.autocast's op lists apply")
        self.enable = bool(enable)
        self.level = level
        self.dtype = _half(dtype)
        self._regions = None

    def __enter__(self):
        self._regions = contextlib.ExitStack()
        devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
        for device in devices:
            self._regions.enter_context(torch.autocast(
                device, dtype=self.dtype, enabled=self.enable))
        return self

    def __exit__(self, *exc):
        return self._regions.__exit__(*exc)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at O2 the models' parameters are cast to
    the half dtype in place (an optimizer built on them keeps them; with
    ``multi_precision`` it keeps fp32 masters)."""
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=_half(dtype))
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """``paddle.amp.GradScaler``: dynamic loss scaling."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place and note whether
        any entry is inf or NaN (one host read)."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        if self._scale != 1.0:
            torch._foreach_mul_(grads, 1.0 / self._scale)
        # a gradient's max |g| is finite exactly when all its entries are;
        # reading that on the host is what a captured step cannot do (the
        # reference's trace fails here the same way)
        no_host_read("GradScaler's found_inf check")
        max_abs = torch.stack(torch._foreach_norm(grads, math.inf))
        if getattr(self, "_sync_found_inf", False):
            # distributed.shard_scaler: every rank of a sharded model
            # skips the same steps
            import torch.distributed as tdist

            bad = (~torch.isfinite(max_abs)).any().float()
            if tdist.is_available() and tdist.is_initialized():
                tdist.all_reduce(bad, op=tdist.ReduceOp.MAX)
            self._found_inf = bool(bad)
            return
        self._found_inf = not bool(torch.isfinite(max_abs).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]


def is_bfloat16_supported(place=None):
    """True on the CPU; on a card, whether it computes in bf16."""
    if place is not None and torch.device(place).type == "cuda":
        return torch.cuda.is_bf16_supported()
    return True


def is_float16_supported(place=None):
    """True: the CPU and every CUDA card compute in fp16."""
    return True
