from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .common import (affine_grid, channel_shuffle, fold,  # noqa: F401
                     grid_sample, interpolate, pixel_shuffle,
                     pixel_unshuffle, temporal_shift, unfold, upsample)
from .conv import conv2d
from .extras import (flash_attention_with_sparse_mask, flash_attn_qkvpacked,
                     flash_attn_varlen_qkvpacked)
from .flash_attention import (flash_attention, flash_attn_unpadded,
                              scaled_dot_product_attention)
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d
from .sampling import sample_logits, sample_logits_per_slot

__all__ = sorted(_activation + _common + _loss + _norm + [
    "adaptive_avg_pool2d", "avg_pool2d", "conv2d", "flash_attention",
    "flash_attention_with_sparse_mask", "flash_attn_qkvpacked",
    "flash_attn_unpadded", "flash_attn_varlen_qkvpacked", "max_pool2d",
    "sample_logits", "sample_logits_per_slot",
    "scaled_dot_product_attention"])
