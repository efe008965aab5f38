"""Optimizers: the port of paddle_tpu/optimizer/__init__.py.

``Adam`` and ``AdamW`` run the reference's ``_adam_math``, all in fp32::

    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    update = (m / (1 - b1**t)) / (sqrt(v / (1 - b2**t)) + eps)
    p = p * (1 - lr * wd) - lr * update

with ``g`` upcast (plus Adam's L2 term), ``p`` the fp32 master under
``multi_precision``, ``lr`` the base lr times the parameter's group
scale, ``wd`` the decoupled decay (AdamW; 0 for Adam), ``t`` the raised
step count in fp32 and, under ``amsgrad``, ``v`` replaced by its running
maximum in the update. ``moment_dtype`` stores the moments narrower (e.g.
bf16) and upcasts them for the math. AdamW decays every parameter unless
``apply_decay_param_fun(name)`` says otherwise or a group overrides the
decay: biases, LayerNorm weights and embeddings too, as the reference
does. ``lr_ratio`` is accepted and not read, as in the reference.

By default (``use_multi_tensor``, on as in the reference) the whole step
is fused: `ops.kernels.multi_tensor.multi_tensor_norm` gives the clip's
global norm (a bound `nn.ClipGradByGlobalNorm`) and, when guarded, the
non-finite flag; `multi_tensor_adam` then updates every parameter in one
launch per dtype group, folding in the unscale, the clip scale (rounded
as the clip would round it) and the gate. On CPU tensors both run their
plain versions. ``use_multi_tensor=False`` is the reference's opt-out:
the per-parameter loop over the same per-tensor rule (`adam_math`), bit
for bit the fused result on the CPU.

The other optimizers (``SGD``, ``Momentum``, ``Adamax``, ``Adadelta``,
``Adagrad``, ``RMSProp``, ``ASGD``, ``Lamb``, ``NAdam``, ``RAdam``,
``Rprop``, ``LBFGS``) are per-parameter tensor rules, as in the
reference, which has no fused path for them.
"""
from __future__ import annotations

import torch

from ..nn.clip import ClipGradByGlobalNorm, any_over
from ..ops.kernels.multi_tensor import (adam_consts, adam_math,
                                        multi_tensor_adam, multi_tensor_norm,
                                        tensor_lr)
from . import lr  # noqa: F401
from .optimizer import Optimizer

__all__ = ["ASGD", "LBFGS", "SGD", "Adadelta", "Adagrad", "Adam", "AdamW",
           "Adamax", "Lamb", "Momentum", "NAdam", "Optimizer", "RAdam",
           "RMSProp", "Rprop", "lr"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _append_optimize_op(self, p, g):
        self._write_param(p, self._param_value(p) - self._cur_lr(p) * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _append_optimize_op(self, p, g):
        v = self._get_accumulator("velocity", p)
        v_new = self._momentum * v + g
        self._set_accumulator("velocity", p, v_new)
        update = g + self._momentum * v_new if self._nesterov else v_new
        self._write_param(p, self._param_value(p) - self._cur_lr(p) * update)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=None, amsgrad=False, moment_dtype=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = bool(amsgrad)
        self._use_multi_tensor = (True if use_multi_tensor is None
                                  else bool(use_multi_tensor))
        self._moment_dtype = (_DTYPES[moment_dtype]
                              if isinstance(moment_dtype, str)
                              else moment_dtype)
        # the per-parameter path's device scalars of the current step:
        # `adam_consts` and each (lr scale, decay)'s `tensor_lr`
        self._step_consts = {}

    # -- the per-tensor coefficients ---------------------------------------
    def _decoupled_wd(self, p):
        """AdamW's decoupled decay of ``p`` (0 for Adam, whose decay is an
        L2 term folded into the gradient)."""
        return 0.0

    def _l2_coeff(self, p):
        """The L2 term of ``p`` (none with a ``regularizer`` of its own,
        as in the reference); the fused and per-parameter paths both
        read it."""
        wd = self._param_group_wd(p)
        if wd is None:
            wd = self._weight_decay
        if wd is None or getattr(p, "regularizer", None) is not None:
            return 0.0
        return float(wd if isinstance(wd, float)
                     else getattr(wd, "_coeff", 0.0))

    def _apply_decay(self, p, g):
        # the L2 term is part of the rule (`adam_math`), on the fp32 value
        return g

    def _state_of(self, p):
        """``(m, v, vmax)``, made at first use in ``moment_dtype``."""
        md = self._moment_dtype
        return (self._get_accumulator("moment1", p, dtype=md),
                self._get_accumulator("moment2", p, dtype=md),
                self._get_accumulator("moment2_max", p, dtype=md)
                if self._amsgrad else None)

    # -- the per-parameter path (use_multi_tensor=False) -------------------
    def _append_optimize_op(self, p, g):
        pv = self._param_value(p)
        m, v, vmax = self._state_of(p)
        consts = self._step_consts
        if "k" not in consts:
            consts["k"] = adam_consts(self._beta1, self._beta2,
                                      self._epsilon, self._t())
        key = (self._param_lr_scale(p), self._decoupled_wd(p), p.device)
        if key not in consts:
            consts[key] = tensor_lr(self.get_lr(), *key)
        k, (lr_t, decay) = consts["k"], consts[key]
        out, m_new, v_new, vmax_new = adam_math(
            pv.float(), g.float(), m.float(), v.float(),
            None if vmax is None else vmax.float(), lr_t, decay,
            self._l2_coeff(p), k)
        m.copy_(m_new)
        v.copy_(v_new)
        if vmax is not None:
            vmax.copy_(vmax_new)
        self._write_param(p, out)

    def _before_update(self):
        self._step_consts.clear()

    # -- the fused step ----------------------------------------------------
    def _maybe_fused_step(self, params_grads, inv_scale=None, guard=False):
        if not self._use_multi_tensor or not params_grads:
            return False
        clip = self._grad_clip
        global_clip = isinstance(clip, ClipGradByGlobalNorm)
        stats = found = None
        if guard or global_clip:
            stats, found = multi_tensor_norm(
                [g for _, g in params_grads],
                need_clip=[global_clip and getattr(p, "need_clip", True)
                           for p, _ in params_grads],
                inv_scale=inv_scale,
                clip_norm=clip.clip_norm if global_clip else None,
                # another clip reads the unscaled grads
                write=clip is not None and not global_clip)
            if guard:
                found = any_over(found, getattr(self, "_found_group", None))
        if clip is not None and not global_clip:
            params_grads = clip(params_grads)
            inv_scale = None
        params = [p for p, _ in params_grads]
        states = [self._state_of(p) for p in params]
        multi_tensor_adam(
            params, [g for _, g in params_grads],
            [self._master_weight(p) if self._use_master(p) else None
             for p in params],
            [s[0] for s in states], [s[1] for s in states],
            [s[2] for s in states] if self._amsgrad else None,
            lr=self.get_lr(), beta1=self._beta1, beta2=self._beta2,
            eps=self._epsilon, step=self._step_tensor(),
            lr_scales=[self._param_lr_scale(p) for p in params],
            wds=[self._decoupled_wd(p) for p in params],
            l2s=[self._l2_coeff(p) for p in params],
            need_clip=[getattr(p, "need_clip", True) for p in params],
            found_inf=found if guard else None, inv_scale=inv_scale,
            clip_scale=stats[1] if global_clip else None)
        return found if guard else None


class AdamW(Adam):
    """Adam with decoupled weight decay (default 0.01, on every parameter
    unless ``apply_decay_param_fun(name)`` returns False; the name is the
    one given with the parameter, as ``named_parameters()`` gives it; a
    group's ``weight_decay`` overrides it)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 moment_dtype=None, use_multi_tensor=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         use_multi_tensor=use_multi_tensor, amsgrad=amsgrad,
                         moment_dtype=moment_dtype, name=name)
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
        gwd = self._param_group_wd(p)
        return self._wd_coeff if gwd is None else gwd

    # the decay is decoupled: never also an L2 term, group overrides
    # included (`_decoupled_wd` takes them)
    def _l2_coeff(self, p):
        return 0.0


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, p, g):
        m = self._get_accumulator("moment", p)
        u = self._get_accumulator("inf_norm", p)
        t = self._t()
        m_new = self._beta1 * m + (1 - self._beta1) * g
        u_new = torch.maximum(self._beta2 * u, g.abs())
        self._set_accumulator("moment", p, m_new)
        self._set_accumulator("inf_norm", p, u_new)
        step = self._cur_lr(p) / (1 - self._beta1 ** t)
        self._write_param(p, self._param_value(p)
                          - step * m_new / (u_new + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._epsilon = rho, epsilon

    def _append_optimize_op(self, p, g):
        avg_sq = self._get_accumulator("avg_squared_grad", p)
        avg_up = self._get_accumulator("avg_squared_update", p)
        rho, eps = self._rho, self._epsilon
        avg_sq_new = rho * avg_sq + (1 - rho) * g * g
        update = (avg_up + eps).sqrt() / (avg_sq_new + eps).sqrt() * g
        avg_up_new = rho * avg_up + (1 - rho) * update * update
        self._set_accumulator("avg_squared_grad", p, avg_sq_new)
        self._set_accumulator("avg_squared_update", p, avg_up_new)
        self._write_param(p, self._param_value(p) - self._cur_lr(p) * update)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _append_optimize_op(self, p, g):
        acc = self._get_accumulator("moment", p, init=self._initial,
                                    dtype=torch.float32)
        g32 = g.to(acc.dtype)
        acc_new = acc + g32 * g32
        self._set_accumulator("moment", p, acc_new)
        self._write_param(p, self._param_value(p) - self._cur_lr(p) * g
                          / (acc_new.sqrt() + self._epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, p, g):
        rho = self._rho
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum", p)
        ms_new = rho * ms + (1 - rho) * g * g
        self._set_accumulator("mean_square", p, ms_new)
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            mg_new = rho * mg + (1 - rho) * g
            self._set_accumulator("mean_grad", p, mg_new)
            denom = (ms_new - mg_new * mg_new + self._epsilon).sqrt()
        else:
            denom = (ms_new + self._epsilon).sqrt()
        mom_new = self._momentum * mom + self._cur_lr(p) * g / denom
        self._set_accumulator("momentum", p, mom_new)
        self._write_param(p, self._param_value(p) - mom_new)


class ASGD(Optimizer):
    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._batch_num = batch_num

    def _append_optimize_op(self, p, g):
        d = self._get_accumulator("d", p)
        ys = self._get_accumulator("ys", p)
        # the current grad replaces the oldest in the window (the
        # reference's window of 1)
        d_new = d - ys + g
        self._set_accumulator("d", p, d_new)
        self._set_accumulator("ys", p, g)
        self._write_param(p, self._param_value(p)
                          - (self._cur_lr(p) / self._batch_num) * d_new)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, p, g):
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        t = self._t()
        b1, b2 = self._beta1, self._beta2
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        self._set_accumulator("moment1", p, m_new)
        self._set_accumulator("moment2", p, v_new)
        m_hat = m_new / (1 - b1 ** t)
        v_hat = v_new / (1 - b2 ** t)
        pv = self._param_value(p)
        r = m_hat / (v_hat.sqrt() + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None
                     and self._exclude_fn(p)) else self._wd
        update = r + wd * pv
        w_norm = torch.linalg.vector_norm(pv)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        self._write_param(p, pv - self._cur_lr(p) * trust * update)


class NAdam(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    @property
    def _mu_product(self):
        # an accumulator, so state_dict and the gate carry it
        store = self._accumulators.setdefault("nadam_mu_product", {})
        if "_global" not in store:
            store["_global"] = torch.ones((), device=self._device())
            self._track(store["_global"], whole_step=True)
        return store["_global"]

    def _mu(self, t):
        return self._beta1 * (1 - 0.5 * 0.96 ** (t * self._psi))

    def _append_optimize_op(self, p, g):
        t = self._t()
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        mu_t, mu_t1 = self._mu(t), self._mu(t + 1)
        mu_prod = self._mu_product * mu_t
        b1, b2 = self._beta1, self._beta2
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        self._set_accumulator("moment1", p, m_new)
        self._set_accumulator("moment2", p, v_new)
        v_hat = v_new / (1 - b2 ** t)
        update = (mu_t1 * m_new / (1 - mu_prod * mu_t1)
                  + (1 - mu_t) * g / (1 - mu_prod)) / (v_hat.sqrt()
                                                       + self._epsilon)
        self._write_param(p, self._param_value(p) - self._cur_lr(p) * update)

    def _after_update(self):
        self._mu_product.mul_(self._mu(self._t()))


class RAdam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, p, g):
        t = self._t()
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        b1, b2 = self._beta1, self._beta2
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        self._set_accumulator("moment1", p, m_new)
        self._set_accumulator("moment2", p, v_new)
        m_hat = m_new / (1 - b1 ** t)
        rho_inf = 2 / (1 - b2) - 1
        rho_t = rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        # branchless, as the reference (t is a device scalar)
        v_hat = (v_new / (1 - b2 ** t)).sqrt()
        r_sq = ((rho_t - 4) * (rho_t - 2) * rho_inf) / (
            (rho_inf - 4) * (rho_inf - 2) * rho_t)
        r = r_sq.clamp(min=0.0).sqrt()
        update = torch.where(rho_t > 5.0, r * m_hat / (v_hat + self._epsilon),
                             m_hat)
        self._write_param(p, self._param_value(p) - self._cur_lr(p) * update)


class Rprop(Optimizer):
    def __init__(self, learning_rate=0.01, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, False,
                         name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _append_optimize_op(self, p, g):
        prev_g = self._get_accumulator("prev_grad", p)
        lr_acc = self._get_accumulator("lr", p, init=self.get_lr(),
                                       dtype=torch.float32)
        sign = torch.sign(g * prev_g)
        lr_new = torch.where(sign > 0, lr_acc * self._eta_pos,
                             torch.where(sign < 0, lr_acc * self._eta_neg,
                                         lr_acc)).clamp(self._lr_min,
                                                        self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        self._set_accumulator("prev_grad", p, g_eff)
        self._set_accumulator("lr", p, lr_new)
        self._write_param(p, self._param_value(p) - lr_new * g_eff.sign())


class LBFGS(Optimizer):
    """Limited-memory BFGS as the reference has it: the closure-free
    SGD-fallback step (its two-loop recursion is not written yet)."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)

    def _append_optimize_op(self, p, g):
        self._write_param(p, self._param_value(p) - self.get_lr() * g)

    def step(self, closure=None):
        if closure is not None:
            loss = closure()
            super().step()
            return loss
        super().step()
