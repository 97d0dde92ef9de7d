from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaModel, llama3_8b_config,
                                           llama_shard_fn,
                                           llama_tiny_config)
from paddle_tpu_torch.models.ssm import (HybridSSMForCausalLM, HybridSSMModel,
                                         SSMConfig, ssm_tiny_config)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "llama_tiny_config", "llama3_8b_config", "llama_shard_fn",
           "SSMConfig",
           "HybridSSMModel", "HybridSSMForCausalLM", "ssm_tiny_config"]
