from . import hybrid_parallel_util, sequence_parallel_utils  # noqa: F401
from .hybrid_parallel_util import fused_allreduce_gradients  # noqa: F401
