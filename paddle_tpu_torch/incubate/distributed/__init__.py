"""``paddle.incubate.distributed``: so far the mixture-of-experts layer
(`models.moe`)."""
from . import models  # noqa: F401
