from .conv import conv2d
from .extras import flash_attn_qkvpacked
from .flash_attention import flash_attention, scaled_dot_product_attention
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import batch_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d
from .sampling import sample_logits, sample_logits_per_slot

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm", "conv2d",
           "cross_entropy", "flash_attention", "flash_attn_qkvpacked",
           "fused_linear_cross_entropy", "max_pool2d", "sample_logits",
           "sample_logits_per_slot", "scaled_dot_product_attention"]
