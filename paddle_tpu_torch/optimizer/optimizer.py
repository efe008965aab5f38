"""Optimizer base: the port of paddle_tpu/optimizer/optimizer.py.

It keeps the parameter list, the grad clip, the step count (raised before
the update, as the reference does), a float learning rate with
`get_lr` / `set_lr`, per-parameter accumulators, and the
``multi_precision`` master weights: an fp32 master for every bf16/fp16
parameter, created lazily at its first update from the low-precision
parameter itself (upcast), updated in fp32 and written back as the master
and then the downcast parameter (`_write_param`).

PyTorch updates in place where the JAX package returned new arrays: the
accumulators, masters and parameters keep their storage across steps.
Learning-rate schedulers (paddle_tpu/optimizer/lr.py) and parameter
groups are not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet; pass a float "
                "and use set_lr")
        if parameters is None:
            raise ValueError("the optimizer needs parameters=")
        self._learning_rate = float(learning_rate)
        # plain tensors, or (name, tensor) pairs as named_parameters()
        # gives them: names reach apply_decay_param_fun
        self._parameter_list, self._names = [], {}
        for entry in parameters:
            if isinstance(entry, dict):
                raise NotImplementedError(
                    "parameter groups are not ported yet")
            if isinstance(entry, tuple):
                name, entry = entry
                self._names[entry] = name
            self._parameter_list.append(entry)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._weight_decay = (float(weight_decay) if weight_decay else 0.0)
        self._accumulators = {}    # name -> {param: tensor}
        self._master_weights = {}  # param -> fp32 tensor
        self._step_count = 0

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- state -------------------------------------------------------------
    def _use_master(self, p):
        return self._multi_precision and p.dtype in (torch.float16,
                                                     torch.bfloat16)

    def _get_accumulator(self, name, p, dtype=None):
        store = self._accumulators.setdefault(name, {})
        if p not in store:
            dt = dtype or (torch.float32 if self._use_master(p) else p.dtype)
            store[p] = torch.zeros(p.shape, dtype=dt, device=p.device)
        return store[p]

    def _master_weight(self, p):
        if p not in self._master_weights:
            self._master_weights[p] = p.detach().float()   # a copy
        return self._master_weights[p]

    def _param_value(self, p):
        """What the update reads: the fp32 master, or the parameter."""
        return self._master_weight(p) if self._use_master(p) else p.detach()

    def _write_param(self, p, value):
        """Store the updated fp32 value: master first, then the parameter
        in its own dtype."""
        if self._use_master(p):
            self._master_weights[p].copy_(value)
        p.detach().copy_(value)

    # -- step --------------------------------------------------------------
    def _params_grads(self):
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        params_grads = self._params_grads()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        self._update(params_grads)

    def _update(self, params_grads):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        """Drop the grads (their memory goes back to the allocator)."""
        for p in self._parameter_list:
            p.grad = None
