"""Weight bridge from the reference package's parameters to the port.

``load_paddle_tpu_state(model, params)`` takes numpy arrays keyed by the
reference's parameter names (``llama.layers.0.self_attn.q_proj.weight``,
...) — for example ``{k: np.asarray(v._value) for k, v in
jax_model.state_dict().items()}`` — and copies them into a port model of
the same configuration. paddle keeps Linear weights as ``[in, out]``
(``x @ w``); torch keeps ``[out, in]``, so those are transposed (GPT's
fused ``qkv_proj`` ``[h, 3h]`` becomes ``[3h, h]``, its q|k|v order
kept; every ``nn.Linear`` of BERT). Everything else (embeddings, BERT's
three among them, LayerNorm and RMSNorm weights, biases) is copied as
it is, and so are the MoE layers' raw parameters: the expert banks
``w0`` / ``w1`` ``[E, in, out]`` with their ``[E, 1, out]`` biases and a
gate's ``[d, E]`` weight, which are parameters in the reference's
layout, not ``nn.Linear``s. A tied model has no ``lm_head`` key, as in
the reference. Every name and shape is checked: a missing or extra key,
or a shape that does not fit, raises before anything is copied.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_paddle_tpu_state"]


def _linear_weight_names(model: nn.Module):
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def load_paddle_tpu_state(model: nn.Module,
                          params: Dict[str, np.ndarray]) -> nn.Module:
    """Copy reference-package weights into ``model`` in place (cast to
    each parameter's dtype, on its device). Returns ``model``."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(
            f"load_paddle_tpu_state: parameter names differ — missing "
            f"{missing[:8]}{' ...' if len(missing) > 8 else ''}, extra "
            f"{extra[:8]}{' ...' if len(extra) > 8 else ''}")
    linear = _linear_weight_names(model)
    staged = {}
    for name, p in own.items():
        arr = np.asarray(params[name])
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)      # ml_dtypes bf16 -> numpy f32
        if name in linear:
            if arr.ndim != 2:
                raise ValueError(f"load_paddle_tpu_state: {name} is a Linear "
                                 f"weight but has shape {arr.shape}")
            arr = arr.T                       # paddle [in, out] -> [out, in]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"load_paddle_tpu_state: {name} has shape {arr.shape} after "
                f"layout conversion, the model expects {tuple(p.shape)}")
        staged[name] = arr
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(torch.tensor(staged[name]))
    return model
