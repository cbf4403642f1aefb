"""fleet.utils: ``recompute`` (activation checkpointing).

Counterpart of ``paddle_tpu/distributed/fleet/utils/__init__.py``. The
region runs once without keeping its activations; the backward replays
it and differentiates the replay. Here that is ``torch.utils.checkpoint``
(non-reentrant). The port's attention dropout draws from explicit
``torch.Generator``s, which ``preserve_rng_state`` does not cover, so the
region also runs under a ``core.generator.GeneratorTape``: the replay
starts each generator from the state the first run found, so it draws
the same flash seed (and the same plain-path masks) as the first run.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ....core.generator import GeneratorTape

__all__ = ["recompute"]


def recompute(function, *args, **kwargs):
    """``paddle.distributed.fleet.utils.recompute``: ``function(*args,
    **kwargs)`` without storing its intermediate activations. Takes the
    reference's ``preserve_rng_state`` (default True); ``use_reentrant``
    is accepted and the non-reentrant form is always used."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    tape = GeneratorTape()

    def run(*a, **k):
        with tape.run():
            return function(*a, **k)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **kwargs)
