from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaModel, llama3_8b_config,
                                           llama_tiny_config)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "llama_tiny_config", "llama3_8b_config"]
