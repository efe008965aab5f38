"""The Megatron pairing pass: the port's own copy of ``_assign_roles``
and ``_is_fused_proj`` of paddle_tpu/distributed/auto_parallel/
spmd_rules.py (:99-143), over ``torch.nn.Linear`` children.

Inside each parent module the last of two or more Linear children is
row-parallel and the rest column-parallel (qkv -> out_proj, fc1 -> fc2;
q, k, v -> out); a lone Linear is column-parallel, and a fused
multi-projection Linear (qkv: out = 3 x in; gate_up: out = 2 x in with a
name hint) is column-parallel wherever it stands. The port's Linear
weight is ``[out, in]``, the reference's ``[in, out]``.
"""
from __future__ import annotations

import re

import torch

__all__ = ["assign_roles", "is_fused_proj"]


def is_fused_proj(sub, attr_name=""):
    """A fused multi-projection Linear (reference ``_is_fused_proj``)."""
    w = getattr(sub, "weight", None)
    if w is None or w.dim() != 2:
        return False
    out, inp = w.shape
    if out == 3 * inp:
        return True
    return out == 2 * inp and bool(
        re.search(r"qkv|gate_up|fused|in_proj", attr_name, re.I))


def assign_roles(module):
    """{id(Linear): "column" | "row"} over ``module``'s tree (reference
    ``_assign_roles``)."""
    roles = {}
    for _, parent in module.named_modules():
        lin = [(n, s) for n, s in parent.named_children()
               if type(s) is torch.nn.Linear or type(s).__name__ == "Linear"]
        for i, (n, s) in enumerate(lin):
            role = "row" if len(lin) >= 2 and i == len(lin) - 1 else "column"
            if role == "row" and is_fused_proj(s, attr_name=n):
                role = "column"
            roles[id(s)] = role
    return roles
