"""Shared rotary-embedding rotation (counterpart of
``paddle_tpu/incubate/nn/functional/_rope_common.py``): one source for
the model's rope and the serving engine's."""
from __future__ import annotations

import torch

__all__ = ["rotate_half"]


def rotate_half(t: torch.Tensor, neox: bool) -> torch.Tensor:
    """neox=True splits the feature dim in halves ([-x2, x1]);
    neox=False pairs even/odd lanes."""
    if neox:
        t1, t2 = torch.chunk(t, 2, dim=-1)
        return torch.cat([-t2, t1], dim=-1)
    t1 = t[..., 0::2]
    t2 = t[..., 1::2]
    return torch.stack([-t2, t1], dim=-1).reshape(t.shape)
