"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A package beside ``paddle_tpu`` (the JAX reference, which stays as it
is). It imports torch and numpy and never jax or paddle_tpu. Entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
every kernel the reference wrote in Pallas becomes a hand-written CUDA
kernel under ``csrc/`` with a plain PyTorch version beside it, which is
what a CPU tensor runs.

Eight slices are ported. Serving: ``models.LlamaForCausalLM``,
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
``incubate.nn.functional.fused_ec_moe``. ResNet and the diffusion UNet:
``vision.models.resnet50`` and its family, ``models.UNet2DConditionModel``
and ``models.DDPMScheduler``, with ``nn.functional``'s convolutions,
pools, batch / group / instance norms and ``interpolate`` (torch's ops,
as the reference leaves them to XLA; the UNet's attention runs the flash
kernels). Measurement from inside the program: ``observability`` (step
telemetry with device-timed ``train.step_seconds``, MFU against the
card's peak, memory gauges, health detectors fed by training steps and
the serving engine, the metrics dump and its renderers), ``profiler``
(host spans and the card's kernels by name and class over
``torch.profiler``), ``device`` (``paddle.device``: CUDA streams and
events, the caching allocator's stats) and ``utils.flops`` (also
``paddle_tpu_torch.flops``). Distributed training: ``distributed``
(process groups over ``torch.distributed``, NCCL on the card and gloo on
the CPU; the collectives, the rendezvous store, the launcher
``python -m paddle_tpu_torch.distributed.launch`` and ``DataParallel``,
also ``paddle_tpu_torch.DataParallel``).
"""
from . import (amp, convert, device, jit, models, nn, observability,
               optimizer, profiler, regularizer, serve, utils, vision)
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
           "resolve_device", "amp", "convert", "device", "jit", "models",
           "nn", "observability", "optimizer", "profiler", "regularizer",
           "serve", "utils", "vision"]


def __getattr__(name):
    # resolved on first use, as the reference resolves them
    # (paddle_tpu/__init__.py:109-123)
    import sys

    if name == "flops":
        from .utils.flops import dynamic_flops as value
    elif name == "DataParallel":
        from .distributed import DataParallel as value
    else:
        raise AttributeError(
            f"module 'paddle_tpu_torch' has no attribute {name!r}")
    setattr(sys.modules[__name__], name, value)
    return value
