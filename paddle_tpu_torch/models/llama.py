"""Llama model family — the inference forward and the training loss.

Counterpart of ``paddle_tpu/models/llama.py``. Modules are
``torch.nn.Module``s with the reference's names (so parameter names
match ``llama.layers.0.self_attn.q_proj.weight`` and friends), but
Linear weights are torch's ``[out, in]`` where the reference keeps
paddle's ``[in, out]`` (``convert.load_paddle_tpu_state`` transposes).

Attention goes through ``nn.functional.scaled_dot_product_attention``
(the flash kernels when their gate passes) and RMSNorm through
``nn.functional.rms_norm`` (the RMSNorm kernels), forward and backward. ``labels=``
returns the loss: through the chunked fused lm-head cross-entropy when
``config.fused_lm_head_ce`` is set, through ``cross_entropy`` on full
logits otherwise. ``recompute=True`` checkpoints each decoder layer.
``generate`` decodes with a KV cache (``models/generation.py``).
Context parallelism waits for the distributed slice and raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.generator import make_generator
from ..core.place import resolve_device
from ..distributed.fleet.utils import recompute
from ..incubate.nn.functional import (fused_linear_cross_entropy,
                                      fused_rotary_position_embedding, swiglu)
from ..nn import functional as F
from ..nn.functional.common import Embedding

__all__ = ["LlamaConfig", "LlamaRMSNorm", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "fused_qkv_linear"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    recompute: bool = False  # activation checkpointing per decoder layer
    # labels= loss through the chunked fused lm-head + cross-entropy
    fused_lm_head_ce: bool = True
    # compute-time q|k|v weight concat: one [h+2*kv, h] projection; the
    # parameters stay separate
    fused_qkv: bool = False
    dtype: str = "float32"
    context_parallel: Optional[str] = None

    def __post_init__(self):
        if self.context_parallel not in (None, "ring", "ulysses"):
            raise ValueError(
                f"context_parallel must be None, 'ring' or 'ulysses', "
                f"got {self.context_parallel!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{self.dtype!r}")

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=8192,
            rope_theta=500000.0,
        )

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
        )
        base.update(kw)
        return LlamaConfig(**base)


class LlamaRMSNorm(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(config.hidden_size, **factory))
        self.eps = config.rms_norm_eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.eps)


def fused_qkv_linear(x, projs):
    """One wide product against the concatenated weights of ``projs``
    (``nn.Linear``s sharing the input ``x``), split back per projection.
    The bias is concatenated when every projection has one; a mix raises
    ``ValueError``, as in the reference. The parameters stay separate:
    only the computation is fused."""
    w = torch.cat([p.weight for p in projs], dim=0)
    biases = [p.bias for p in projs]
    if all(bb is not None for bb in biases):
        b = torch.cat(biases)
    elif any(bb is not None for bb in biases):
        raise ValueError(
            "fused_qkv_linear: projections mix bias and bias-free "
            "layers; fuse only uniform projections (or disable "
            "fused_qkv for this model)")
    else:
        b = None
    out = torch.nn.functional.linear(x, w, b)
    return list(out.split([p.weight.shape[0] for p in projs], dim=-1))


class LlamaAttention(nn.Module):
    """GQA attention."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        kv = self.num_kv_heads * self.head_dim
        self.q_proj = nn.Linear(h, h, bias=False, **factory)
        self.k_proj = nn.Linear(h, kv, bias=False, **factory)
        self.v_proj = nn.Linear(h, kv, bias=False, **factory)
        self.o_proj = nn.Linear(h, h, bias=False, **factory)

    def forward(self, hidden_states, position_ids=None, attention_mask=None):
        b, s, h = hidden_states.shape
        projs = (self.q_proj, self.k_proj, self.v_proj)
        if self.config.fused_qkv:
            q, k, v = fused_qkv_linear(hidden_states, projs)
        else:
            q, k, v = (p(hidden_states) for p in projs)
        q = q.reshape(b, s, self.num_heads, self.head_dim)
        k = k.reshape(b, s, self.num_kv_heads, self.head_dim)
        v = v.reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k, v = fused_rotary_position_embedding(
            q, k, v, position_ids=position_ids, use_neox_rotary_style=True,
            rotary_emb_base=self.config.rope_theta)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask,
            is_causal=attention_mask is None, training=self.training)
        return self.o_proj(out.reshape(b, s, h))


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False, **factory)
        self.up_proj = nn.Linear(h, i, bias=False, **factory)
        self.down_proj = nn.Linear(i, h, bias=False, **factory)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(config, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self.input_layernorm = LlamaRMSNorm(config, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(config, **factory)

    def forward(self, hidden_states, position_ids=None, attention_mask=None):
        residual = hidden_states
        hidden_states = self.input_layernorm(hidden_states)
        hidden_states = self.self_attn(hidden_states, position_ids,
                                       attention_mask)
        hidden_states = residual + hidden_states
        residual = hidden_states
        hidden_states = self.post_attention_layernorm(hidden_states)
        hidden_states = self.mlp(hidden_states)
        return residual + hidden_states


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, **factory)

    def forward(self, input_ids, position_ids=None, attention_mask=None):
        hidden_states = self.embed_tokens(input_ids)
        for layer in self.layers:
            if self.config.recompute:
                hidden_states = recompute(layer, hidden_states, position_ids,
                                          attention_mask)
            else:
                hidden_states = layer(hidden_states, position_ids,
                                      attention_mask)
        return self.norm(hidden_states)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM. ``device=None`` builds on the card (and raises
    without one); pass ``device="cpu"`` for the CPU. Parameters are made
    in ``config.dtype`` from ``seed`` with an explicit generator:
    normal(0, 0.02) for projections and embeddings, ones for norms."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        if config.context_parallel:
            raise NotImplementedError(
                "LlamaConfig.context_parallel waits for the distributed "
                "slice of the port")
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=_DTYPES[config.dtype])
        self.config = config
        self.llama = LlamaModel(config, **factory)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, **factory)
        self._init_weights(seed, dev)

    @torch.no_grad()
    def _init_weights(self, seed: int, device):
        gen = make_generator(seed, device)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                labels=None):
        """Logits [B, S, V]; with ``labels`` (``-100`` ignored) the mean
        token loss: ``(loss, None)`` through the fused lm-head
        cross-entropy, or ``(loss, logits)`` when
        ``config.fused_lm_head_ce`` is off."""
        hidden_states = self.llama(input_ids, position_ids, attention_mask)
        h, v = self.config.hidden_size, self.config.vocab_size
        if labels is not None and self.config.fused_lm_head_ce:
            loss = fused_linear_cross_entropy(
                hidden_states.reshape(-1, h), self.lm_head.weight,
                labels.reshape(-1), ignore_index=-100)
            return loss, None
        logits = self.lm_head(hidden_states)
        if labels is not None:
            loss = F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                                   ignore_index=-100)
            return loss, logits
        return logits

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id=None, seed: int = 0, pad_token_id=None,
                 paged: bool = False, block_size: int = 64,
                 num_blocks=None,
                 num_beams: int = 1, length_penalty: float = 0.0,
                 repetition_penalty: float = 1.0, min_length: int = 0):
        """KV-cache incremental decoding on the model's device
        (``models/generation.py``). Greedy by default; sampling via
        do_sample + temperature/top_k/top_p from a generator seeded with
        ``seed``; ``pad_token_id`` enables left-padded ragged prompts;
        ``paged=True`` decodes over a paged KV pool through the varlen and
        paged decode kernels (``num_blocks`` caps the pool and fails
        loudly on exhaustion); ``num_beams > 1`` is beam search. Returns
        [B, prompt + max_new_tokens] int64, the prompt included."""
        from .generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         do_sample=do_sample, temperature=temperature,
                         top_k=top_k, top_p=top_p,
                         eos_token_id=eos_token_id, seed=seed,
                         pad_token_id=pad_token_id, paged=paged,
                         block_size=block_size, num_blocks=num_blocks,
                         num_beams=num_beams,
                         length_penalty=length_penalty,
                         repetition_penalty=repetition_penalty,
                         min_length=min_length)
