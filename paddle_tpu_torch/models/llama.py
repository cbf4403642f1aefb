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
``context_parallel="ring"`` or ``"ulysses"`` runs the attention over the
sequence sharded on the ``cp_mesh_axis`` of the hybrid group
(``fleet.context_parallel``): each rank takes its chunk of the tokens
(``fleet.meta_parallel.SegmentParallel``, which ``fleet.distributed_model``
puts around the model at a ``sep_degree`` above 1), and its rotary
positions are global, rank ``r``'s default ones starting at
``r * S_local``. Labels are not shifted inside the model, so each rank's
chunk of labels lines up with its chunk of ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.generator import make_generator
from ..core.place import resolve_device
from ..distributed.communication.group import axis_group
from ..distributed.fleet.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    check_divides, column_projections, global_numel, lm_cross_entropy,
    mp_shard_, vocab_parallel_fused_linear_cross_entropy)
from ..distributed.fleet.utils import recompute
from ..incubate.nn.functional import (_rope_tables, _rotate_qk,
                                      fused_linear_cross_entropy,
                                      fused_rotary_position_embedding,
                                      swiglu)
from ..nn import functional as F
from ..nn.functional.common import Embedding

__all__ = ["LlamaConfig", "LlamaRMSNorm", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "fused_qkv_linear", "llama_shard_plan"]

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
    # context parallelism: "ring" | "ulysses" | None, over the hybrid
    # group's cp_mesh_axis (fleet.context_parallel)
    context_parallel: Optional[str] = None
    cp_mesh_axis: str = "sep"

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
    enter = getattr(projs[0], "enter", None)   # a tensor-parallel layer
    if enter is not None:
        x = enter(x)
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
            q, k, v = column_projections(hidden_states, projs)
        # -1: a tensor-parallel rank holds its share of the heads
        q = q.reshape(b, s, -1, self.head_dim)
        k = k.reshape(b, s, -1, self.head_dim)
        v = v.reshape(b, s, -1, self.head_dim)
        if self.config.context_parallel:
            if attention_mask is not None:
                raise NotImplementedError(
                    "context_parallel attention is causal-only; custom "
                    "attention_mask is not supported under ring/ulysses")
            out = self._cp_attention(q, k, v, position_ids)
        else:
            q, k, v = fused_rotary_position_embedding(
                q, k, v, position_ids=position_ids,
                use_neox_rotary_style=True,
                rotary_emb_base=self.config.rope_theta)
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attention_mask,
                is_causal=attention_mask is None, training=self.training)
        return self.o_proj(out.reshape(b, s, -1))

    def _cp_attention(self, q, k, v, position_ids):
        """Ring or Ulysses attention over this rank's chunk of the
        sequence, at global rotary positions (the default ones start at
        the chunk's first token); the key-value heads are repeated to the
        query heads first, as in the reference."""
        from ..distributed.fleet import context_parallel as cp

        axis = self.config.cp_mesh_axis
        s, d = q.shape[1], q.shape[3]
        n, start = cp.seq_chunk(s, axis=axis)
        if position_ids is None:
            position_ids = torch.arange(start, start + s,
                                        device=q.device)[None]
        # the tables span the whole sequence: the positions are global
        cos, sin = _rope_tables(n * s, d, self.config.rope_theta, True,
                                q.dtype, q.device)
        q, k = _rotate_qk(q, k, cos, sin, position_ids, True)
        if k.shape[2] != q.shape[2]:
            rep = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        fn = {"ring": cp.ring_attention, "ulysses": cp.ulysses_attention}[
            self.config.context_parallel]
        return fn(q, k, v, axis=axis, causal=True)


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False, **factory)
        self.up_proj = nn.Linear(h, i, bias=False, **factory)
        self.down_proj = nn.Linear(i, h, bias=False, **factory)

    def forward(self, x):
        gate, up = column_projections(x, (self.gate_proj, self.up_proj))
        return self.down_proj(swiglu(gate, up))


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
        h = self.config.hidden_size
        group = getattr(self.lm_head, "mp_group", None)
        if labels is not None and self.config.fused_lm_head_ce:
            if group is None:
                loss = fused_linear_cross_entropy(
                    hidden_states.reshape(-1, h), self.lm_head.weight,
                    labels.reshape(-1), ignore_index=-100)
            else:
                loss = vocab_parallel_fused_linear_cross_entropy(
                    hidden_states.reshape(-1, h), self.lm_head.weight,
                    labels.reshape(-1), group, ignore_index=-100)
            return loss, None
        logits = self.lm_head(hidden_states)
        if labels is not None:
            return lm_cross_entropy(logits, labels, group), logits
        return logits

    def num_parameters(self) -> int:
        return sum(global_numel(p) for p in self.parameters())

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


def llama_shard_plan(model: LlamaForCausalLM, mesh, dp_axis="dp",
                     mp_axis="mp"):
    """Megatron tensor parallelism over ``mesh``'s ``mp_axis``, the
    reference's plan (``paddle_tpu/models/llama.py`` ``llama_shard_plan``)
    in torch's ``[out, in]`` layout:

    - ``embed_tokens.weight``: ``Shard(0)``, vocab parallel
      (``VocabParallelEmbedding``);
    - ``q/k/v/gate/up_proj.weight``: ``Shard(0)`` (the reference's
      ``Shard(1)`` of ``[in, out]``), column parallel;
    - ``o_proj/down_proj.weight``: ``Shard(1)`` (its ``Shard(0)``), row
      parallel;
    - ``lm_head.weight``: ``Shard(0)``, vocab parallel, with the
      vocab-parallel fused cross-entropy;
    - the norms replicated.

    Every parameter is sharded in place (``DistParameter``: an optimizer
    built before sees it), and each rank computes on its shard: the
    attention on ``num_heads / mp`` heads and ``num_key_value_heads /
    mp`` key-value heads, the MLP on ``intermediate_size / mp``, so the
    kernels get local tensors. Where mp does not divide the vocabulary,
    the heads, the key-value heads or the MLP width the plan raises
    ``ValueError`` naming both numbers (the reference's GSPMD pads
    instead). The data-parallel axis is left to ``DataParallel(mesh=)``.
    """
    cfg = model.config
    check_divides("llama_shard_plan", {
        "vocab_size": cfg.vocab_size,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "intermediate_size": cfg.intermediate_size},
        mesh.get_dim_size(mp_axis))
    group = axis_group(mesh, mp_axis)
    replicate = dict(group=group, dim=None)
    llama = model.llama
    llama.embed_tokens = VocabParallelEmbedding.from_embedding(
        llama.embed_tokens, group)
    for layer in llama.layers:
        attn, mlp = layer.self_attn, layer.mlp
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(attn, name, ColumnParallelLinear.from_linear(
                getattr(attn, name), group))
        attn.o_proj = RowParallelLinear.from_linear(attn.o_proj, group)
        for name in ("gate_proj", "up_proj"):
            setattr(mlp, name, ColumnParallelLinear.from_linear(
                getattr(mlp, name), group))
        mlp.down_proj = RowParallelLinear.from_linear(mlp.down_proj, group)
        mp_shard_(layer.input_layernorm.weight, **replicate)
        mp_shard_(layer.post_attention_layernorm.weight, **replicate)
    mp_shard_(llama.norm.weight, **replicate)
    model.lm_head = ColumnParallelLinear.from_linear(model.lm_head, group)
    return model
