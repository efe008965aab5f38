"""Activation recomputation: the port of paddle_tpu/distributed/fleet/
recompute.py's ``recompute``.

``recompute(function, *args, policy=None)`` runs ``function(*args)``
under a non-reentrant ``torch.utils.checkpoint``: the backward runs it
again (the generator state restored, so dropout draws the same masks)
and keeps only its inputs. Policies, as the reference names them:

* None, "nothing", "full": keep nothing of the inside (full recompute);
* "dots": the reference's ``jax.checkpoint_policies.
  dots_with_no_batch_dims_saveable``: keep the products without batch
  dimensions (the Linear layers' ``aten.mm`` / ``aten.addmm``) and
  recompute the rest, as a selective checkpoint.

``use_reentrant`` and ``preserve_rng_state`` are taken for the
reference's signature; the checkpoint is always non-reentrant and keeps
the generator state.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["POLICIES", "recompute"]

POLICIES = (None, "nothing", "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def recompute(function, *args, policy=None, use_reentrant=True,
              preserve_rng_state=True):
    """``function(*args)``, its inside recomputed in the backward."""
    if policy not in POLICIES:
        raise ValueError(
            f"unknown recompute policy {policy!r}; use 'dots' or "
            f"'nothing'/'full'")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(function, *args, use_reentrant=False, **kw)
