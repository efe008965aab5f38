from .bert import (BERT_CONFIGS, BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_config)
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTPretrainingCriterion, fused_lm_loss, gpt_config,
                  match_sharding)
from .gpt_pipe import GPTForCausalLMPipe, gpt_pipe_sharding_rules
from .llama import (LLAMA_CONFIGS, LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion, llama_config,
                    llama_sharding_rules)

__all__ = ["BERT_CONFIGS", "BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert_config",
           "GPTConfig", "GPT_CONFIGS", "gpt_config", "GPTForCausalLM",
           "GPTForCausalLMPipe", "gpt_pipe_sharding_rules",
           "GPTModel", "GPTPretrainingCriterion", "fused_lm_loss",
           "match_sharding",
           "LLAMA_CONFIGS", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion", "llama_config",
           "llama_sharding_rules"]
