"""Fleet layers: the Megatron tensor-parallel layers (`mpu`)."""
from . import mpu  # noqa: F401
