"""Seeded random generators.

Counterpart of ``paddle_tpu/core/generator.py``, which keeps one jax
threefry key per named stream and splits a subkey per draw. The port
keeps no global stream: every consumer (model init, the serving
engine's sampler, attention dropout) owns an explicit
``torch.Generator`` on its device, made here from a seed. jax keys and
torch generators give different numbers from the same seed, so tests
that compare the two packages feed both the same numpy inputs.

Activation recompute replays a region's forward during the backward.
``torch.utils.checkpoint`` restores the global CPU and CUDA generators
for the replay, but not these explicit ones, so a region runs under a
:class:`GeneratorTape`: every consumer passes its generator through
:func:`use_generator` before drawing, the first run records each
generator's state at its first draw, and a replay starts each one from
that state and gives the generator back its own state afterwards. The
reference does the same with its key streams (``recompute`` snapshots
``generator._snapshot_keys()``).

A captured CUDA graph (``jit/_capture.py``) must register every explicit
generator it draws from before the capture starts, so that each replay
advances the generator's offset as the eager call did. The capture's
warm-up run notes them: :func:`recording` collects every generator
announced through :func:`use_generator` inside its block.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["make_generator", "draw_seed", "use_generator", "GeneratorTape",
           "recording"]

_active = threading.local()


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One int32 seed drawn on ``device`` (shape ``[1]``) — the in-kernel
    counter hash's seed, the way ``flash_attention_fused`` folds a jax
    key into one int32. Drawn on the device so no host sync happens."""
    use_generator(generator)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         device=device, generator=generator)


class GeneratorTape:
    """The generator states of one recompute region (see the module
    docstring). Use one tape per region, and enter :meth:`run` around
    every run of it: the first records, each later one replays."""

    def __init__(self):
        self._start = {}          # id(gen) -> (gen, state at first draw)
        self._recorded = False

    @contextlib.contextmanager
    def run(self):
        live = {}                 # id(gen) -> (gen, state to give back)
        stack = getattr(_active, "tapes", [])
        _active.tapes = stack + [(self, live)]
        try:
            yield
        finally:
            _active.tapes = stack
            self._recorded = True
            for gen, state in live.values():
                gen.set_state(state)

    def _see(self, gen, live):
        key = id(gen)
        if not self._recorded:
            self._start.setdefault(key, (gen, gen.get_state()))
        elif key in self._start and key not in live:
            live[key] = (gen, gen.get_state())
            gen.set_state(self._start[key][1])


def use_generator(generator: torch.Generator) -> torch.Generator:
    """Announce a draw from ``generator`` to the recompute regions and
    the :func:`recording` blocks that are running (a no-op outside them);
    returns the generator."""
    for tape, live in getattr(_active, "tapes", ()):
        tape._see(generator, live)
    for seen in getattr(_active, "recorders", ()):
        seen.setdefault(id(generator), generator)
    return generator


@contextlib.contextmanager
def recording():
    """Collect the generators drawn from inside the block: yields a dict
    ``id -> generator`` that fills as :func:`use_generator` is called."""
    seen = {}
    stack = getattr(_active, "recorders", [])
    _active.recorders = stack + [seen]
    try:
        yield seen
    finally:
        _active.recorders = stack
