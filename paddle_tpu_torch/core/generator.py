"""Seeded random generators.

Counterpart of ``paddle_tpu/core/generator.py``, which keeps one jax
threefry key per named stream and splits a subkey per draw. The port
keeps no global stream: every consumer (model init, the serving
engine's sampler, attention dropout) owns an explicit
``torch.Generator`` on its device, made here from a seed. jax keys and
torch generators give different numbers from the same seed, so tests
that compare the two packages feed both the same numpy inputs.
"""
from __future__ import annotations

import torch

__all__ = ["make_generator", "draw_seed"]


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One int32 seed drawn on ``device`` (shape ``[1]``) — the in-kernel
    counter hash's seed, the way ``flash_attention_fused`` folds a jax
    key into one int32. Drawn on the device so no host sync happens."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), dtype=torch.int32,
                         device=device, generator=generator)
