"""Gradient clipping: the port of paddle_tpu/nn/clip.py's
``ClipGradByGlobalNorm``.

A clip is called by `optimizer.Optimizer.step` on the ``(param, grad)``
pairs it is about to apply. The global norm is taken in fp32 from the
grads as stored (bf16 grads stay bf16: the norm upcasts, the grads do
not), ``scale = min(clip_norm / max(norm, 1e-12), 1)``, and every grad is
scaled and rounded back to its own dtype. Parameters with
``need_clip = False`` are neither counted nor scaled. The grads are
scaled in place, where the reference returned new arrays.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, params_grads):
        """The fp32 global norm of the clipped grads (a device scalar), or
        None when there are none."""
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "need_clip", True)]
        if not grads:
            return None
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads])
        return norms.square().sum().sqrt()

    @torch.no_grad()
    def __call__(self, params_grads):
        norm = self.global_norm(params_grads)
        if norm is None:
            return params_grads
        scale = (self.clip_norm / norm.clamp(min=1e-12)).clamp(max=1.0)
        for p, g in params_grads:
            if g is not None and getattr(p, "need_clip", True):
                scale_(g, scale)
        return params_grads


def scale_(g, scale):
    """``g = (g * scale)`` in fp32, rounded to g's dtype, in place. (An
    in-place multiply of a bf16 tensor would round ``scale`` to bf16
    first.)"""
    if g.dtype == torch.float32:
        g.mul_(scale)
    else:
        g.copy_(g.float().mul_(scale))
