from .ernie import (ErnieConfig, ErnieForMaskedLM, ErnieForQuestionAnswering,
                    ErnieForSequenceClassification,
                    ErnieForTokenClassification, ErnieModel,
                    ernie_tiny_config)
from .gpt import GPTConfig, GPTForCausalLM, gpt2_small_config, gpt_tiny_config
from .llama import (LlamaConfig, LlamaForCausalLM, llama3_8b_config,
                    llama_tiny_config)

__all__ = ["ErnieConfig", "ErnieForMaskedLM", "ErnieForQuestionAnswering",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieModel", "GPTConfig", "GPTForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "ernie_tiny_config", "gpt2_small_config",
           "gpt_tiny_config", "llama3_8b_config", "llama_tiny_config"]
