"""Optimizers: the port of paddle_tpu/optimizer/__init__.py's ``Adam`` and
``AdamW``.

The update is the reference's ``_adam_math``, all in fp32::

    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    update = (m / (1 - b1**t)) / (sqrt(v / (1 - b2**t)) + eps)
    p = p * (1 - lr * wd) - lr * update

with ``g`` upcast, ``p`` the fp32 master under ``multi_precision``, and
``wd`` the decoupled decay (AdamW; 0 for Adam, whose ``weight_decay`` is
an L2 term folded into the gradient). ``moment_dtype`` stores the moments
narrower (e.g. bf16) and upcasts them for the math. AdamW decays every
parameter unless ``apply_decay_param_fun(name)`` says otherwise: biases,
LayerNorm weights and embeddings too, as the reference does. Like the
reference this is plain tensor code, not a kernel; the update runs in
place, one parameter at a time.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=None, amsgrad=False, moment_dtype=None,
                 name=None):
        if amsgrad:
            raise NotImplementedError("amsgrad is not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_dtype = (_DTYPES[moment_dtype]
                              if isinstance(moment_dtype, str)
                              else moment_dtype)

    def _decoupled_wd(self, p):
        return 0.0

    def _l2_coeff(self, p):
        return self._weight_decay

    def _update(self, params_grads):
        lr = self.get_lr()
        t = self._step_count
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        md = self._moment_dtype
        for p, g in params_grads:
            pv = self._param_value(p)
            m = self._get_accumulator("moment1", p, dtype=md)
            v = self._get_accumulator("moment2", p, dtype=md)
            g32 = g.float()
            l2 = self._l2_coeff(p)
            if l2:
                g32 = g32 + l2 * pv.float()
            m32 = m.float().mul_(b1).add_(g32, alpha=1 - b1)
            v32 = v.float().mul_(b2).addcmul_(g32, g32, value=1 - b2)
            update = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(eps))
            wd = self._decoupled_wd(p)
            out = pv.float().mul_(1 - lr * wd).sub_(update.mul_(lr))
            m.copy_(m32)
            v.copy_(v32)
            self._write_param(p, out)


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01, on every parameter
    unless ``apply_decay_param_fun(name)`` returns False; the name is the
    one given with the parameter, as ``named_parameters()`` gives it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 moment_dtype=None, use_multi_tensor=None, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, moment_dtype=moment_dtype,
                         name=name)
        self._wd_coeff = float(weight_decay) if weight_decay else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_wd(self, p):
        fun = self._apply_decay_param_fun
        if fun is not None:
            if p not in self._names:
                raise ValueError(
                    "apply_decay_param_fun needs named parameters: pass "
                    "parameters=model.named_parameters()")
            if not fun(self._names[p]):
                return 0.0
        return self._wd_coeff

    def _l2_coeff(self, p):
        return 0.0
