"""Model zoo of the port (the Llama family so far), and ``generate``."""
from .generation import generate
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel, LlamaRMSNorm)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP", "LlamaRMSNorm",
           "generate"]
