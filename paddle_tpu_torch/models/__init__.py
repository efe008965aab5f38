from .gpt import GPT_CONFIGS, GPTConfig, GPTForCausalLM, GPTModel, gpt_config

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTForCausalLM",
           "GPTModel"]
