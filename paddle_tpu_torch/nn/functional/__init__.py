from .extras import flash_attn_qkvpacked
from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import cross_entropy, fused_linear_cross_entropy
from .sampling import sample_logits, sample_logits_per_slot

__all__ = ["cross_entropy", "flash_attention", "flash_attn_qkvpacked",
           "fused_linear_cross_entropy", "sample_logits",
           "sample_logits_per_slot", "scaled_dot_product_attention"]
