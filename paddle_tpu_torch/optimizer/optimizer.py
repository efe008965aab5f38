"""Optimizer base: the port of paddle_tpu/optimizer/optimizer.py.

It keeps the parameter list and its groups (a group's ``learning_rate``
is a scale of the base lr, its ``weight_decay`` overrides the optimizer's;
both kept on the optimizer, keyed by parameter), the grad clip, the step
count, the learning rate (a float with `get_lr` / `set_lr`, or an
`lr.LRScheduler` the caller steps), per-parameter accumulators and the
``multi_precision`` master weights: an fp32 master for every bf16/fp16
parameter, created from the low-precision parameter itself (upcast) at its
first update, updated in fp32 and written back as the master and then the
downcast parameter (`_write_param`).

The step count lives on the device (an int32 counter on the parameters'
device), so a gated step can leave it alone without reading anything
back; `_step_count` reads it when asked. `step` raises it before the
update, as the reference does. Optimizers with a fused update (`Adam`,
`AdamW`) take it through `_maybe_fused_step`; the others run
`_append_optimize_op` one parameter at a time, with L2 decay folded into
the gradient (`_apply_decay`).

A global-norm clip (`nn.ClipGradByGlobalNorm`) on the per-parameter path
takes its scale from one `multi_tensor_norm` and scales each grad as its
update reads it, so no second copy of the grads exists and ``p.grad`` is
never written, as in the reference (the other clips return new grads).

`_guarded_step` is the training step's gate (`jit.TrainStep` with a
``scaler`` or ``guard_nonfinite``): it unscales the grads, finds a
non-finite one and skips the update on the device. The fused update
skips inside its kernel; the per-parameter path selects each
parameter's old state (the parameter, its master and accumulators, and
what its update creates) back with ``torch.where`` right after that
parameter's update, as the reference's ``gate`` does, so at most one
parameter's state is copied at a time; the count and the optimizer-wide
accumulators are selected back after the loop. No host read either way.

PyTorch updates in place where the JAX package returned new arrays: the
accumulators, masters and parameters keep their storage across steps.
"""
from __future__ import annotations

import torch

from ..nn.clip import ClipGradByGlobalNorm, any_over, scaled
from ..ops.kernels.multi_tensor import multi_tensor_norm
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("the optimizer needs parameters=")
        self._learning_rate = learning_rate
        # plain tensors, (name, tensor) pairs as named_parameters() gives
        # them (names reach apply_decay_param_fun and state_dict), or
        # groups: dicts of "params" with "learning_rate" (a scale of the
        # base lr) and "weight_decay" overrides
        self._parameter_list, self._names = [], {}
        self._group_lr_scale, self._group_wd = {}, {}
        for entry in parameters:
            if isinstance(entry, dict):
                for p in self._add_params(entry["params"]):
                    if "learning_rate" in entry:
                        self._group_lr_scale[p] = float(
                            entry["learning_rate"])
                    if "weight_decay" in entry:
                        wd = entry["weight_decay"]
                        self._group_wd[p] = (
                            float(wd) if isinstance(wd, (int, float))
                            else getattr(wd, "_coeff", 0.0))
            else:
                self._add_params([entry])
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._weight_decay = (float(weight_decay)
                              if isinstance(weight_decay, (int, float))
                              else weight_decay)
        self._accumulators = {}    # name -> {param: tensor}
        self._master_weights = {}  # param -> fp32 tensor
        self._step_t = None        # the device step counter (int32)
        self._step_host = 0        # the count before the counter exists
        # the gate's (live, old) pairs of one parameter's update, and of
        # the whole step
        self._snapshot = self._step_snapshot = None
        # the group over which the grads differ (a hybrid-parallel
        # optimizer's pp x mp group): the guard's flag is one flag there
        self._found_group = None

    def _add_params(self, entries):
        added = []
        for entry in entries:
            if isinstance(entry, tuple):
                name, entry = entry
                self._names[entry] = name
            self._parameter_list.append(entry)
            added.append(entry)
        return added

    # -- lr ----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.get_lr()
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _param_lr_scale(self, p):
        if p in self._group_lr_scale:
            return self._group_lr_scale[p]
        return (getattr(p, "optimize_attr", None) or {}).get(
            "learning_rate", 1.0)

    def _param_group_wd(self, p):
        return self._group_wd.get(p)

    def _cur_lr(self, p):
        """The base lr times ``p``'s group scale."""
        lr, scale = self.get_lr(), self._param_lr_scale(p)
        return lr * scale if scale != 1.0 else lr

    # -- the step count ------------------------------------------------------
    def _device(self):
        return self._parameter_list[0].device if self._parameter_list \
            else torch.device("cpu")

    def _step_tensor(self):
        if self._step_t is None:
            self._step_t = torch.tensor(self._step_host, dtype=torch.int32,
                                        device=self._device())
        return self._step_t

    @property
    def _step_count(self):
        """The step count as a Python int (reads the device counter)."""
        return self._step_host if self._step_t is None \
            else int(self._step_t)

    @_step_count.setter
    def _step_count(self, value):
        if self._step_t is None:
            self._step_host = int(value)
        else:
            self._step_t.fill_(int(value))

    def _t(self):
        """The (raised) step count as an fp32 device scalar."""
        return self._step_tensor().float()

    # -- state -------------------------------------------------------------
    def _use_master(self, p):
        return self._multi_precision and p.dtype in (torch.float16,
                                                     torch.bfloat16)

    def _get_accumulator(self, name, p, init=None, dtype=None):
        """``p``'s accumulator ``name``, made at its first use: zeros in
        ``dtype`` (default fp32 under a master, else ``p``'s dtype), or
        ``init`` filled."""
        store = self._accumulators.setdefault(name, {})
        if p not in store:
            dt = dtype or (torch.float32 if self._use_master(p) else p.dtype)
            t = torch.zeros(p.shape, dtype=dt, device=p.device) \
                if init is None else torch.full(p.shape, init, dtype=dt,
                                                device=p.device)
            self._track(t)
            store[p] = t
        return store[p]

    def _set_accumulator(self, name, p, value):
        self._accumulators[name][p].copy_(value)

    def _master_weight(self, p):
        if p not in self._master_weights:
            self._master_weights[p] = p.detach().float()   # a copy
            self._track(self._master_weights[p])
        return self._master_weights[p]

    def _track(self, t, whole_step=False):
        """State made inside a gated step: its initial value is the old
        one the gate restores, after the update of the parameter that made
        it, or with ``whole_step`` (state that every update reads) after
        the loop."""
        snap = self._step_snapshot if whole_step else self._snapshot
        if snap is not None:
            snap.append((t, t.clone()))

    def _param_value(self, p):
        """What the update reads: the fp32 master, or the parameter."""
        return self._master_weight(p) if self._use_master(p) else p.detach()

    def _write_param(self, p, value):
        """Store the updated fp32 value: master first, then the parameter
        in its own dtype."""
        if self._use_master(p):
            self._master_weights[p].copy_(value)
        p.detach().copy_(value)

    def _apply_decay(self, p, g):
        """L2 regularization folded into the gradient (the group's
        ``weight_decay`` or the optimizer's); none for a parameter with a
        ``regularizer`` of its own (`nn.ParamAttr`), as in the
        reference."""
        wd = self._param_group_wd(p)
        if wd is None:
            wd = self._weight_decay
        if wd is None:
            return g
        coeff = wd if isinstance(wd, float) else getattr(wd, "_coeff", 0.0)
        if coeff == 0.0 or getattr(p, "regularizer", None) is not None:
            return g
        return g + coeff * self._param_value(p).to(g.dtype)

    # -- step --------------------------------------------------------------
    def _params_grads(self):
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        self._run_step(self._params_grads())

    @torch.no_grad()
    def _guarded_step(self, inv_scale=None):
        """The gated step of `jit.TrainStep`: unscale the grads by
        ``inv_scale`` (a device fp32 scalar, or None), and update unless
        some grad is not finite (judged before the unscale). Returns
        ``found_inf``, a device bool; nothing is read back."""
        return self._run_step(self._params_grads(), inv_scale, guard=True)

    def _run_step(self, params_grads, inv_scale=None, guard=False):
        found = self._maybe_fused_step(params_grads, inv_scale, guard)
        if found is not False:
            return found
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
                write=inv_scale is not None, device=self._device())
            found = any_over(found, getattr(self, "_found_group", None)) if guard else None
        if clip is not None and not global_clip:
            params_grads = clip(params_grads)
        self._step_snapshot = snap = (
            None if found is None
            else [(t, t.clone()) for t in self._step_state()])
        try:
            self._step_tensor().add_(1)
            self._before_update()
            for p, g in params_grads:
                if global_clip and getattr(p, "need_clip", True):
                    g = scaled(g, stats[1])
                if self._use_master(p):
                    g = g.float()
                self._gated_update(found, p, g)
            self._after_update()
        finally:
            self._step_snapshot = None
        _select_back(found, snap)
        return found

    def _gated_update(self, found, p, g):
        """``p``'s update (its L2 decay folded into ``g``). With ``found``
        (a device bool), its state (the parameter, its master, its
        accumulators and what the update creates) is selected back to the
        old values where it is set."""
        if found is None:
            self._append_optimize_op(p, self._apply_decay(p, g))
            return
        self._snapshot = snap = [(t, t.clone())
                                 for t in self._state_of_param(p)]
        try:
            self._append_optimize_op(p, self._apply_decay(p, g))
        finally:
            self._snapshot = None
        _select_back(found, snap)

    def _before_update(self):
        """Subclass hook: once a step, after the count is raised and before
        the first parameter's update (Adam's per-step scalars)."""

    def _after_update(self):
        """Subclass hook: state advanced once a step, after every
        parameter's update (NAdam's momentum product)."""

    def _step_state(self):
        """The count and the accumulators keyed by no parameter (NAdam's
        momentum product)."""
        yield self._step_tensor()
        for store in self._accumulators.values():
            for k, t in store.items():
                if not isinstance(k, torch.Tensor):
                    yield t

    def _state_of_param(self, p):
        """``p``, its master and its accumulators, as they are now."""
        yield p.detach()
        if p in self._master_weights:
            yield self._master_weights[p]
        for store in self._accumulators.values():
            if p in store:
                yield store[p]

    def _state(self):
        yield self._step_tensor()
        for p in self._parameter_list:
            yield p.detach()
        yield from self._master_weights.values()
        for store in self._accumulators.values():
            yield from store.values()

    def _maybe_fused_step(self, params_grads, inv_scale=None, guard=False):
        """Subclass hook: apply the whole step (clip, count, update) as
        one fused program and return ``found_inf`` (None unguarded);
        False when not handled (the per-parameter path runs)."""
        return False

    def _append_optimize_op(self, p, g):
        raise NotImplementedError

    @torch.no_grad()
    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=True):
        """Drop the grads (their memory goes back to the allocator)."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # -- state dict -----------------------------------------------------------
    def _key(self, p):
        """A parameter's name in the state dict: its given name, else
        ``param_<index>`` in the parameter list (non-parameter keys, like
        NAdam's ``_global``, as they are)."""
        if not isinstance(p, torch.Tensor):
            return p
        if p in self._names:
            return self._names[p]
        for i, q in enumerate(self._parameter_list):
            if q is p:
                return f"param_{i}"
        raise KeyError("not a parameter of this optimizer")

    def _lookup(self):
        table = {self._key(p): p for p in self._parameter_list}
        return lambda k: table.get(k, k)

    def state_dict(self):
        state = {
            "accumulators": {
                name: {self._key(p): t.detach().clone()
                       for p, t in store.items()}
                for name, store in self._accumulators.items()},
            "master_weights": {self._key(p): t.detach().clone()
                               for p, t in self._master_weights.items()},
            "step": self._step_count,
        }
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state_dict):
        find = self._lookup()
        for name, store in state_dict.get("accumulators", {}).items():
            tgt = self._accumulators.setdefault(name, {})
            for k, v in store.items():
                p = find(k)
                dev = p.device if isinstance(p, torch.Tensor) \
                    else self._device()
                tgt[p] = torch.as_tensor(v).to(dev).clone()
        for k, v in state_dict.get("master_weights", {}).items():
            p = find(k)
            self._master_weights[p] = torch.as_tensor(v).to(
                p.device, torch.float32).clone()
        self._step_count = state_dict.get("step", 0)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    load_state_dict = set_state_dict


def _select_back(found, snap):
    """``live = old`` where ``found`` is set, for each (live, old) pair,
    in place (no temporary of the tensor's size)."""
    for live, old in snap or ():
        torch.where(found, old, live, out=live)
