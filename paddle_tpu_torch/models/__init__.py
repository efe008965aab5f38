from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, fused_lm_loss, gpt_config)

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTForCausalLM",
           "GPTModel", "GPTPretrainingCriterion", "fused_lm_loss"]
