"""The MoE-aware global-norm clip: the port of paddle_tpu/incubate/
distributed/models/moe/grad_clip.py.

The reference's class counts every expert's grad in the global norm
once, where an expert lives on one expert-parallel rank. On one rank
every expert stack is whole there, so the norm is the plain global norm
of `nn.clip.ClipGradByGlobalNorm`, which this class is;
``is_expert_param_func`` is kept for the reference's signature. A
``moe_group`` of more than one rank raises, naming ROADMAP A9b.3b.
"""
from __future__ import annotations

from .....nn.clip import ClipGradByGlobalNorm
from .moe_layer import A9B3B

__all__ = ["ClipGradForMOEByGlobalNorm"]


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        if moe_group is not None and getattr(moe_group, "nranks", 1) > 1:
            raise NotImplementedError(A9B3B.format(
                "ClipGradForMOEByGlobalNorm over an expert-parallel group"))
        super().__init__(clip_norm, group_name=group_name)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group
