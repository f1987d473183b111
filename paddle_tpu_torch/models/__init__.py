from .llama import (LlamaConfig, LlamaForCausalLM, llama3_8b_config,
                    llama_tiny_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "llama3_8b_config",
           "llama_tiny_config"]
