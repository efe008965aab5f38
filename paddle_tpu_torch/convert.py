"""Carry parameters between the JAX package and the port.

The reference's parameters come across as numpy arrays keyed by its
``named_parameters()`` names, which the port's modules keep. One layout
differs: a Paddle ``Linear.weight`` is ``[in, out]``, a
``torch.nn.Linear.weight`` is ``[out, in]``, so every Linear weight
(``qkv``, ``out_proj``, ``fc1``, ``fc2`` and the untied ``lm_head``) is
transposed on the way in and back on the way out. Embedding and
LayerNorm weights cross as they are. The round trip is bit-exact.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "state_dict_to_jax"]

_LINEAR_WEIGHT = re.compile(
    r"(\.(qkv|out_proj|fc1|fc2)|^lm_head)\.weight$")


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (the reference's comes from
        # ml_dtypes): cross as the raw 16-bit pattern
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_dict_from_jax(named_numpy: dict) -> dict[str, torch.Tensor]:
    """{JAX parameter name: array} -> a state dict for the port's model
    (``GPTForCausalLM.load_state_dict``); CPU tensors, copied."""
    out = {}
    for name, arr in named_numpy.items():
        a = np.asarray(arr)
        if _LINEAR_WEIGHT.search(name):
            a = a.T
        out[name] = _to_torch(np.array(a, order="C"))
    return out


def state_dict_to_jax(state_dict: dict) -> dict[str, np.ndarray]:
    """The inverse of `state_dict_from_jax`: the port's state dict ->
    {JAX parameter name: numpy array} in the reference's layouts."""
    out = {}
    for name, t in state_dict.items():
        a = _to_numpy(t)
        if _LINEAR_WEIGHT.search(name):
            a = a.T
        out[name] = np.ascontiguousarray(a)
    return out
