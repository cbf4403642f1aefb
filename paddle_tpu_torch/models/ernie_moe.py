"""ERNIE-MoE causal LM (ERNIE-4.5-MoE style) — forward, training loss
and ``generate``.

Counterpart of ``paddle_tpu/models/ernie_moe.py``: the Llama decoder
(``LlamaAttention``, ``LlamaRMSNorm``) whose FFN is, on every
``moe_layer_interval``-th layer, a ``FusedMoELayer`` (a top-k gate over
``num_experts`` stacked experts, on the index path) and otherwise the
dense ``LlamaMLP``. The ``labels=`` loss is the token cross-entropy on
full logits plus ``aux_loss_weight`` times the gates' balance losses,
which ``moe_aux_loss`` reads and clears in the same call (so no tensor
of a captured step stays on a gate after it). Parameter names are the
reference's (``model.layers.1.mlp.gate.weight``,
``model.layers.1.mlp.experts.w0``, ...).

Attention and RMSNorm reach the flash and RMSNorm kernels, forward and
backward, as Llama's do; routing and the expert products are plain
PyTorch, as the reference leaves them to XLA. Every routing draw (GShard's
random second expert) comes from the model's one explicit generator,
``routing_generator``. Under ``recompute`` the MoE layers run without
the checkpoint, as in the reference. A ``moe_group`` (or the hybrid
group's ``mp`` axis after ``fleet.init``) shards the expert banks and
puts the MoE layers on the einsum path; ``ernie_moe_shard_plan`` lays
out the reference's mp x ep plan and leaves them on the index path
(``incubate/distributed/models/moe/moe_layer.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.generator import make_generator
from ..core.place import resolve_device
from ..distributed.auto_parallel.api import DistParameter, _shard_param_
from ..distributed.auto_parallel.placement import Replicate
from ..distributed.communication.group import axis_group
from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding,
                                           check_divides, lm_cross_entropy)
from ..distributed.fleet.utils import recompute
from ..incubate.distributed.models.moe.moe_layer import _shard_expert_dim
from ..incubate.distributed.models.moe import FusedMoELayer
from ..incubate.distributed.models.moe.gate import _xavier_uniform_
from ..nn import functional as F
from ..nn.functional.common import Embedding
from .llama import (_DTYPES, LlamaAttention, LlamaConfig, LlamaMLP,
                    LlamaRMSNorm)

__all__ = ["ErnieMoeConfig", "ErnieMoeForCausalLM", "ErnieMoeModel",
           "ErnieMoeDecoderLayer", "ernie_moe_shard_plan"]


@dataclass
class ErnieMoeConfig(LlamaConfig):
    num_experts: int = 8
    moe_top_k: int = 2
    moe_layer_interval: int = 2      # every k-th decoder layer is MoE
    moe_intermediate_size: Optional[int] = None
    aux_loss_weight: float = 0.01
    gate_type: str = "gshard"
    # "swiglu": gate and up projections side by side in one [d, 2h]
    # expert weight; "gelu": the two-product FFN expert
    moe_activation: str = "gelu"

    @staticmethod
    def tiny(**kw) -> "ErnieMoeConfig":
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            num_experts=4, moe_top_k=2, moe_layer_interval=1,
        )
        base.update(kw)
        return ErnieMoeConfig(**base)

    def is_moe_layer(self, idx: int) -> bool:
        return (idx + 1) % self.moe_layer_interval == 0


class ErnieMoeDecoderLayer(nn.Module):
    def __init__(self, config: ErnieMoeConfig, layer_idx: int,
                 moe_group=None, generator=None, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(config, **factory)
        self.input_layernorm = LlamaRMSNorm(config, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(config, **factory)
        self.is_moe = config.is_moe_layer(layer_idx)
        if self.is_moe:
            self.mlp = FusedMoELayer(
                config.hidden_size,
                config.moe_intermediate_size or config.intermediate_size,
                config.num_experts,
                gate={"type": config.gate_type, "topk": config.moe_top_k},
                activation=config.moe_activation, moe_group=moe_group,
                generator=generator, **factory)
        else:
            self.mlp = LlamaMLP(config, **factory)

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


class ErnieMoeModel(nn.Module):
    def __init__(self, config: ErnieMoeConfig, moe_group=None,
                 generator=None, **factory):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **factory)
        self.layers = nn.ModuleList([
            ErnieMoeDecoderLayer(config, i, moe_group=moe_group,
                                 generator=generator, **factory)
            for i in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, **factory)

    def forward(self, input_ids, position_ids=None, attention_mask=None):
        hidden_states = self.embed_tokens(input_ids)
        for layer in self.layers:
            if self.config.recompute and not layer.is_moe:
                # MoE layers run un-checkpointed: a replayed region would
                # set the gate's balance loss a second time
                hidden_states = recompute(layer, hidden_states, position_ids,
                                          attention_mask)
            else:
                hidden_states = layer(hidden_states, position_ids,
                                      attention_mask)
        return self.norm(hidden_states)


class ErnieMoeForCausalLM(nn.Module):
    """ERNIE-MoE causal LM. ``device=None`` builds on the card (and raises
    without one); pass ``device="cpu"`` for the CPU. Parameters are made
    in ``config.dtype`` from ``seed``: the RMSNorm weights 1, the biases
    (gates' and experts') 0, the gates' weights and the expert banks
    paddle's ``XavierUniform``, everything else normal(0, 0.02).
    ``routing_generator`` (seeded with ``seed``, on the model's device)
    feeds every routing draw."""

    def __init__(self, config: ErnieMoeConfig, moe_group=None, device=None,
                 seed: int = 0):
        super().__init__()
        if config.context_parallel:
            raise NotImplementedError(
                "ErnieMoeConfig.context_parallel waits for the distributed "
                "slice of the port")
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=_DTYPES[config.dtype])
        self.config = config
        self.routing_generator = make_generator(seed, dev)
        self.model = ErnieMoeModel(config, moe_group=moe_group,
                                   generator=self.routing_generator,
                                   **factory)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, **factory)
        self._init_weights(seed, dev)

    @torch.no_grad()
    def _init_weights(self, seed: int, device):
        gen = make_generator(seed, device)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif leaf in ("bias", "b0", "b1"):
                p.zero_()
            elif leaf in ("w0", "w1") or name.endswith("mlp.gate.weight"):
                _xavier_uniform_(p, gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def moe_aux_loss(self):
        """The sum of the gates' pending balance losses (clears them), or
        None."""
        total = None
        for layer in self.model.layers:
            gate = getattr(layer.mlp, "gate", None)
            if gate is not None and hasattr(gate, "get_loss"):
                loss = gate.get_loss(clear=True)
                if loss is not None:
                    total = loss if total is None else total + loss
        return total

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                labels=None):
        """Logits [B, S, V]; with ``labels`` (``-100`` ignored) ``(loss,
        logits)``: the mean token cross-entropy plus ``aux_loss_weight``
        times ``moe_aux_loss()``."""
        hidden_states = self.model(input_ids, position_ids, attention_mask)
        logits = self.lm_head(hidden_states)
        if labels is not None:
            loss = lm_cross_entropy(logits, labels,
                                    getattr(self.lm_head, "mp_group", None))
            aux = self.moe_aux_loss()
            if aux is not None:
                loss = loss + self.config.aux_loss_weight * aux
            return loss, logits
        return logits

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id=None, seed: int = 0,
                 num_beams: int = 1, length_penalty: float = 0.0,
                 repetition_penalty: float = 1.0, min_length: int = 0):
        """KV-cache decoding on the model's device, Llama's decode loop
        (``models/generation.py``) with each MoE layer's FFN routed per
        call in eval mode: top-k without random routing, the capacity of
        the gate's current factor over the call's tokens. Dense cache
        only: ragged prompts, ``paged=True`` and speculative decoding
        raise, as in the reference. Returns [B, prompt + max_new_tokens]
        int64."""
        from .generation import generate as _generate

        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         do_sample=do_sample, temperature=temperature,
                         top_k=top_k, top_p=top_p,
                         eos_token_id=eos_token_id, seed=seed,
                         num_beams=num_beams,
                         length_penalty=length_penalty,
                         repetition_penalty=repetition_penalty,
                         min_length=min_length)


def ernie_moe_shard_plan(model: ErnieMoeForCausalLM, mesh, mp_axis="mp",
                         ep_axis="ep"):
    """The reference's mp x ep layout (``paddle_tpu/models/ernie_moe.py``
    ``ernie_moe_shard_plan``) in torch's ``[out, in]`` layout, each
    parameter sharded in place (``DistParameter``):

    - over ``mp_axis`` (where the mesh has it) Megatron tensor
      parallelism as ``llama_shard_plan``'s: the vocabulary of the
      embedding and the lm head (with the vocab-parallel loss), q/k/v and
      the dense MLP's gate and up projections column parallel, o_proj and
      down_proj row parallel;
    - the expert banks ``w0``, ``b0``, ``w1``, ``b1`` ``Shard(0)`` (the
      expert dimension) over ``ep_axis`` where the mesh has it;
    - everything else (the gates, the norms) replicated.

    ``mp_axis`` may be ``ep_axis`` (the reference test's layout). As in
    the reference the plan does not touch the layers' ``moe_group``, so
    the MoE layers keep the index path, each rank routing all of its
    expert group's tokens to its own experts. A width the mp degree does
    not divide raises ``ValueError`` naming both numbers, as
    ``llama_shard_plan``'s; so does an expert count the ep degree does
    not divide. The data-parallel axis is left to
    ``DataParallel(mesh=)``."""
    cfg = model.config
    mp = mesh.get_dim_size(mp_axis) if mp_axis in mesh.dim_names else 1
    if ep_axis in mesh.dim_names:
        check_divides("ernie_moe_shard_plan",
                      {"num_experts": cfg.num_experts},
                      mesh.get_dim_size(ep_axis))
    check_divides("ernie_moe_shard_plan", {
        "vocab_size": cfg.vocab_size,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "intermediate_size": cfg.intermediate_size}, mp)
    ernie = model.model
    if mp_axis in mesh.dim_names:
        group = axis_group(mesh, mp_axis)
        ernie.embed_tokens = VocabParallelEmbedding.from_embedding(
            ernie.embed_tokens, group)
        model.lm_head = ColumnParallelLinear.from_linear(model.lm_head,
                                                         group)
        for layer in ernie.layers:
            attn = layer.self_attn
            for name in ("q_proj", "k_proj", "v_proj"):
                setattr(attn, name, ColumnParallelLinear.from_linear(
                    getattr(attn, name), group))
            attn.o_proj = RowParallelLinear.from_linear(attn.o_proj, group)
            if not layer.is_moe:
                mlp = layer.mlp
                for name in ("gate_proj", "up_proj"):
                    setattr(mlp, name, ColumnParallelLinear.from_linear(
                        getattr(mlp, name), group))
                mlp.down_proj = RowParallelLinear.from_linear(mlp.down_proj,
                                                              group)
    if ep_axis in mesh.dim_names:
        for layer in ernie.layers:
            if layer.is_moe:
                ex = layer.mlp.experts
                for p in (ex.w0, ex.b0, ex.w1, ex.b1):
                    _shard_expert_dim(p, mesh, ep_axis)
    replicated = [Replicate()] * mesh.ndim
    for p in model.parameters():
        if not isinstance(p, DistParameter):
            _shard_param_(p, mesh, replicated)
    return model
