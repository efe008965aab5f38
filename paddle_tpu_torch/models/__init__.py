from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, fused_lm_loss, gpt_config)
from .llama import (LLAMA_CONFIGS, LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion, llama_config,
                    llama_sharding_rules)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTForCausalLM",
           "GPTModel", "GPTPretrainingCriterion", "fused_lm_loss",
           "LLAMA_CONFIGS", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion", "llama_config",
           "llama_sharding_rules"]
