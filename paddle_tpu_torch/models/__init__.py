"""Model zoo of the port (the Llama, GPT, BERT and ERNIE-MoE families),
and ``generate``."""
from .bert import (BertConfig, BertEmbeddings, BertEncoderLayer,
                   BertForPretraining, BertForSequenceClassification,
                   BertModel, bert_shard_plan)
from .ernie_moe import (ErnieMoeConfig, ErnieMoeForCausalLM, ErnieMoeModel,
                        ernie_moe_shard_plan)
from .generation import generate
from .gpt import (GPTAttention, GPTConfig, GPTDecoderLayer, GPTForCausalLM,
                  GPTModel, gpt_shard_plan)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel, LlamaRMSNorm)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP", "LlamaRMSNorm",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "GPTDecoderLayer",
           "GPTAttention", "gpt_shard_plan", "BertConfig", "BertModel",
           "BertForPretraining", "BertForSequenceClassification",
           "BertEmbeddings", "BertEncoderLayer", "bert_shard_plan",
           "ErnieMoeConfig", "ErnieMoeForCausalLM", "ErnieMoeModel",
           "ernie_moe_shard_plan", "generate"]
