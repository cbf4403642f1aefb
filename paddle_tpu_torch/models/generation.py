"""Decode helpers shared with the serving engine.

Counterpart of the subset of ``paddle_tpu/models/generation.py`` that
``serve/engine.py`` needs: parameter views (``_llama_decode_params``),
the fp32 RMSNorm and SwiGLU the engine's stack runs (``_rms``,
``_llama_ffn``), the LM head (``_head_logits``) and per-slot sampling
(``_sample_slot_tokens``). ``generate()``, beam search, speculative
decoding and the GPT / MoE families are not ported yet.

Weights are torch's ``[out, in]``, so ``h @ w`` of the reference is
``F.linear(h, w)`` here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cuda.rms_norm import rms_norm_reference

__all__ = ["_llama_decode_params", "_rms", "_llama_ffn", "_head_logits",
           "_sample_slot_tokens", "_decode_family"]


def _llama_decode_params(model):
    """Detached views of the model's parameter tensors plus its shape
    statics."""
    cfg = model.config
    layers = []
    for layer in model.llama.layers:
        a, m = layer.self_attn, layer.mlp
        layers.append(dict(
            ln1=layer.input_layernorm.weight.detach(),
            wq=a.q_proj.weight.detach(), wk=a.k_proj.weight.detach(),
            wv=a.v_proj.weight.detach(), wo=a.o_proj.weight.detach(),
            ln2=layer.post_attention_layernorm.weight.detach(),
            wg=m.gate_proj.weight.detach(), wu=m.up_proj.weight.detach(),
            wd=m.down_proj.weight.detach(),
        ))
    return dict(
        embed=model.llama.embed_tokens.weight.detach(),
        norm=model.llama.norm.weight.detach(),
        head=model.lm_head.weight.detach(),
        layers=layers,
        nh=cfg.num_attention_heads, nkv=cfg.num_key_value_heads,
        dh=cfg.hidden_size // cfg.num_attention_heads,
        eps=cfg.rms_norm_eps, theta=cfg.rope_theta,
    )


def _rms(h, g, eps, dtype):
    """RMSNorm in fp32, output in ``dtype`` (the plain composition, as in
    the reference's decode paths; ``h`` is in ``dtype`` or fp32, so the
    plain kernel version's one rounding to h's dtype changes nothing)."""
    return rms_norm_reference(h, g, eps=eps).to(dtype)


def _llama_ffn(h, lp, dtype):
    """SwiGLU MLP: silu in fp32, products in ``dtype``."""
    gate = F.silu(F.linear(h, lp["wg"]).float()).to(dtype)
    return F.linear(gate * F.linear(h, lp["wu"]), lp["wd"])


def _decode_family(model):
    """Decode parameters for a supported causal-LM family (Llama only in
    the port)."""
    if hasattr(model, "llama"):
        return _llama_decode_params(model)
    raise TypeError(
        f"the port's decode path supports the Llama family; got "
        f"{type(model).__name__}")


def _head_logits(p, hidden):
    """LM-head logits. The reference's tied-head branch serves only the
    GPT family, which waits for a later slice."""
    return F.linear(hidden, p["head"])


def _sample_slot_tokens(logits, temps, generator):
    """Per-row mixed greedy/sampled decode: logits [B, V] and per-slot
    temperatures [B] (0.0 = greedy for that row) -> token ids [B] int32.
    Sampling is the Gumbel-max trick with Exp(1) noise drawn from
    ``generator`` for every row each call, so a row's draw depends only
    on how many calls came before it (which keeps decode bursts equal to
    single steps)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    noise = torch.empty_like(scaled).exponential_(generator=generator)
    sampled = torch.argmax(scaled - torch.log(noise), dim=-1).to(torch.int32)
    return torch.where(temps > 0.0, sampled, greedy)
