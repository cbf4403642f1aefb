"""Model zoo of the port (the Llama and GPT families so far), and
``generate``."""
from .generation import generate
from .gpt import (GPTAttention, GPTConfig, GPTDecoderLayer, GPTForCausalLM,
                  GPTModel, gpt_shard_plan)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel, LlamaRMSNorm)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP", "LlamaRMSNorm",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "GPTDecoderLayer",
           "GPTAttention", "gpt_shard_plan", "generate"]
