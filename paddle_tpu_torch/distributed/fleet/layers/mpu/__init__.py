"""Megatron tensor parallelism over the mp axis: the port of
paddle_tpu/distributed/fleet/layers/mpu (the layers, the RNG tracker)
with the communication operators of the reference's ``mp_ops.py`` and
the role pairing of its ``spmd_rules.py``."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding,
                        vocab_parallel_cross_entropy)
from .mp_ops import (c_concat, c_identity, c_split,  # noqa: F401
                     mp_allreduce)
from .random import (RNGStatesTracker, get_rng_state_tracker,  # noqa: F401
                     model_parallel_random_seed)

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "RowParallelLinear", "VocabParallelEmbedding", "c_concat",
           "c_identity", "c_split", "get_rng_state_tracker",
           "model_parallel_random_seed", "mp_allreduce",
           "vocab_parallel_cross_entropy"]
