"""Mixture-of-experts on one rank: the port of paddle_tpu/incubate/
distributed/models/moe/ (the gates, `MoELayer` over `ExpertFFN`s, the
MoE-aware global-norm clip). The ep axis (`MoELayer` over an
expert-parallel group, `global_scatter` / `global_gather`) is ROADMAP
A9b.3b and raises."""
from .gate import NaiveGate, top1_gating, top2_gating  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
from .moe_layer import (  # noqa: F401
    ExpertFFN, MoELayer, global_gather, global_scatter,
)
