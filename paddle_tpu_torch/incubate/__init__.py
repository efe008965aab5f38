"""``paddle.incubate``: so far the dense decode step's fused attention."""
