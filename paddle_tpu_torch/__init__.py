"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside ``paddle_tpu`` (the JAX reference, which stays as it
is). It imports torch and numpy and never jax or paddle_tpu. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
every kernel the reference wrote in Pallas becomes a hand-written CUDA
kernel under ``csrc/`` with a plain PyTorch version beside it, which is
what a CPU tensor runs.

Seven slices are ported. Serving: ``models.LlamaForCausalLM``,
``serve.ServeEngine`` and ``serve.run_load``, over the paged-decode,
flash-forward and RMSNorm-forward kernels. Decoding:
``LlamaForCausalLM.generate`` (dense and paged KV caches, the paged one
over the varlen-forward and paged-decode kernels; sampling, beam search)
and ``models.generation.generate_speculative``. Training: the model's
``labels=`` loss, ``loss.backward()`` through the flash- and
RMSNorm-backward kernels, and the rest of the training surface:
``optimizer`` (every optimizer of the reference but LBFGS, Adam and
AdamW updating all parameters in multi-tensor ops; the schedulers of
``optimizer.lr``), ``regularizer`` (``L1Decay``, ``L2Decay``),
``nn.ClipGradBy*`` and ``nn.utils.clip_grad_norm_``, the whole loss
module (``nn.functional``) and ``amp`` (``auto_cast``, ``decorate``,
``GradScaler``). Packed attention:
``nn.functional.flash_attention.flash_attn_unpadded`` and
``nn.functional.flash_attn_varlen_qkvpacked``, forward and backward over
the varlen kernels; and ``tools.conv_calibration`` over the tiled matmul
kernel. Compiled execution: ``jit.to_static`` (a function or a whole
train step captured into a CUDA graph per input signature), and the
serving engine's decode tick and bursts and ``generate``'s decode ticks
run as replayed CUDA graphs (``jit/_capture.py``). GPT:
``models.GPTForCausalLM`` (GPT-2 family: forward, training loss,
``generate`` in every mode, and ``ServeEngine``) with the functional ops
it calls (``nn.functional``'s activations, ``linear``, ``dropout``,
``embedding`` and ``layer_norm``). BERT and ERNIE-MoE:
``models.BertForPretraining`` / ``BertForSequenceClassification`` (the
encoder's padding mask as the flash kernels' key bias, attention dropout
inside them) and ``models.ErnieMoeForCausalLM`` (the Llama decoder with
``incubate.distributed.models.moe``'s gates and expert layers: training
and ``generate``, dense and beam), with ``nn.functional.one_hot`` and
``incubate.nn.functional.fused_ec_moe``.
"""
from . import amp, convert, jit, models, nn, optimizer, regularizer, serve
from .convert import load_paddle_tpu_state
from .core.place import resolve_device
from .models import (BertConfig, BertForPretraining,
                     BertForSequenceClassification, ErnieMoeConfig,
                     ErnieMoeForCausalLM, GPTConfig, GPTForCausalLM,
                     LlamaConfig, LlamaForCausalLM)
from .serve import ServeEngine, default_serving_setup, run_load, warm_engine

__all__ = ["LlamaConfig", "LlamaForCausalLM", "GPTConfig", "GPTForCausalLM",
           "BertConfig", "BertForPretraining", "BertForSequenceClassification",
           "ErnieMoeConfig", "ErnieMoeForCausalLM",
           "ServeEngine", "run_load",
           "warm_engine", "default_serving_setup", "load_paddle_tpu_state",
           "resolve_device", "amp", "convert", "jit", "models", "nn",
           "optimizer", "regularizer", "serve"]
