"""Memory-bounded training of a ``scan_layers`` GPT: the port of
paddle_tpu/jit/fused_scan_step.py's ``FusedScanTrainStep``.

    model = GPTForCausalLM(gpt_config("gpt3-1.3b", scan_layers=True))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16")
    step = FusedScanTrainStep(model, opt, fused_head=True,
                              compute_dtype="bfloat16")
    loss = step(ids, labels)            # a device tensor

The reference differentiates its stacked decoder one layer chunk at a
time in a reverse ``lax.scan`` and updates each chunk's slices of the
stacked parameters inside it, so at most one chunk's grads exist at a
time. This is the same step in eager PyTorch. One call runs:

1. the forward without autograd: the embedding, then each chunk of
   ``layer_chunk`` layers, keeping only each chunk's input (in the
   compute dtype);
2. the head with autograd: ln_f and the LM head (the fused CE with
   ``fused_head``, else dense logits and the criterion; tied or untied),
   ``torch.autograd.grad`` of ``loss * scale`` giving the outer
   parameters' head grads and the last chunk's output grad;
3. with a global-norm clip or a guard, a first reverse pass: each chunk
   recomputed with autograd from its input, its grads folded by one
   `multi_tensor_norm` into device scalars (the clip's sum of squares,
   the non-finite flag) and dropped; then the embedding's grads, the clip
   scale and ``found_inf``, all on the device;
4. the update pass, chunks in reverse: each recomputed, its grads taken,
   and its slices of the stacked parameters, masters and moments (the
   optimizer's own ``[L, ...]`` state) updated in place by one
   `multi_tensor_adam` with ``bump=False``; then the outer parameters
   (head grads plus embedding grads, tied embeddings summing both, taken
   before any outer parameter moves) by one with ``bump=True``, which
   raises the step count once a step;
5. the guard state advanced from the device flag, an ``LRScheduler``
   stepped, and the loss returned on the device.

With ``compute_dtype`` the parameters are stored in fp32 and are their
own masters: each layer's slices are cast as they are read, and autograd
through the cast gives fp32 grads, as the reference's vjp of ``astype``
does. Hidden dropout draws, in each recompute, the masks of the forward:
the generator state of the device is saved before the embedding and each
chunk and restored for its recompute (the reference's per-layer offsets
cannot match torch's generator bit for bit; their contract is what is
kept). No part of a call reads a tensor back to the host, guarded or not:
the learning rate is the optimizer's host float, and the gate is a device
flag the kernels read.

With ``numerics`` (default: ``FLAGS_numerics_monitor``, on) the step
fills the reference's ``[chunks + 1, NFIELDS]`` stats block on the
device: activation rows from the forward, grad rows from the first pass
when it runs and else from the update pass, parameter and update rows
from the update pass (a copy of the chunk's fp32 slices is kept across
its update for ``‖Δw‖²``), and the outer row; `NumericsMonitor` reads it
back lazily.

``scan_unroll`` is accepted and does nothing: it is an XLA scheduling
knob with no eager counterpart. Refused, as in the reference: an
unrolled model, an optimizer other than Adam/AdamW, amsgrad,
``ClipGradByNorm`` and clips of other types, a ``layer_chunk`` that does
not divide ``num_layers``, and with ``compute_dtype`` parameters not
stored in fp32. The head adds the draft heads' weighted loss
(`models.gpt.draft_head_loss`) as the reference's does. An MoE model's
layers return their load-balance aux losses beside their outputs: the
returned loss adds ``moe_aux_weight / num_layers`` times their sum (the
forward's values), and each chunk's recompute-and-grad takes that
weight (times the loss scale) as every aux output's cotangent, so the
routers' and the experts' grads hold the aux's part, as the reference's
vjps do. ``ClipGradForMOEByGlobalNorm`` is the global-norm clip here
(one rank). The reference's retrace sentinel, compile cache, cost and
memory analyses are XLA tools with no counterpart here.
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from ..io.device_prefetcher import DevicePrefetcher
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue)
from ..observability.numerics import (NumericsMonitor, assemble_stats,
                                      monitor_enabled, outer_row)
from ..ops.kernels.multi_tensor import multi_tensor_adam, multi_tensor_norm
from .nonfinite_guard import GuardSpec

__all__ = ["FusedScanTrainStep"]

def _rng_state(dev):
    return (torch.cuda.get_rng_state(dev) if dev.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(dev, state):
    if dev.type == "cuda":
        torch.cuda.set_rng_state(state, dev)
    else:
        torch.set_rng_state(state)


def _sq(ts, need=None, inv=None):
    """(sum of squares of the ``need`` tensors after the unscale by
    ``inv``, found_inf): one `multi_tensor_norm` launch."""
    stats, found = multi_tensor_norm(ts, need_clip=need, inv_scale=inv)
    return stats[0], found


class FusedScanTrainStep:
    def __init__(self, model, optimizer, criterion=None, fused_head=False,
                 compute_dtype=None, layer_chunk=1, scan_unroll=1,
                 scaler=None, guard_nonfinite=None, numerics=None):
        from ..incubate.distributed.models.moe import (
            ClipGradForMOEByGlobalNorm)
        from ..models.gpt import GPTPretrainingCriterion, GPTStackedBlocks
        from ..optimizer import _DTYPES, Adam

        blocks = model.gpt.blocks
        if not isinstance(blocks, GPTStackedBlocks):
            raise ValueError(
                "FusedScanTrainStep needs GPTConfig(scan_layers=True) "
                "(stacked [L, ...] block params); got an unrolled model: "
                "use jit.TrainStep there")
        opt = optimizer
        if not isinstance(opt, Adam):
            raise ValueError("fused scan step supports Adam/AdamW only")
        self._clip_global = None     # ClipGradByGlobalNorm's clip_norm
        self._clip_value = None      # ClipGradByValue's (min, max)
        clip = opt._grad_clip
        if clip is not None:
            if type(clip) in (ClipGradByGlobalNorm,
                              ClipGradForMOEByGlobalNorm):
                self._clip_global = float(clip.clip_norm)
            elif type(clip) is ClipGradByValue:
                self._clip_value = (float(clip.min), float(clip.max))
            elif isinstance(clip, ClipGradByNorm):
                raise ValueError(
                    "ClipGradByNorm clips each tensor by its own norm, "
                    "which for a stacked [L, ...] leaf needs all L layers' "
                    "grads at once: exactly what this step never holds. "
                    "Use ClipGradByGlobalNorm (a first reverse pass) or "
                    "ClipGradByValue (elementwise)")
            else:
                raise ValueError(
                    f"unsupported grad_clip {type(clip).__name__}: the "
                    "fused scan step supports ClipGradByGlobalNorm and "
                    "ClipGradByValue (subclasses with other semantics "
                    "would be miscomputed, so they are refused)")
        if opt._amsgrad:
            raise ValueError("amsgrad moment2_max not supported")
        cfg = model.config
        layer_chunk = int(layer_chunk)
        if layer_chunk < 1 or cfg.num_layers % layer_chunk:
            raise ValueError(f"layer_chunk {layer_chunk} must divide "
                             f"num_layers {cfg.num_layers}")
        if isinstance(compute_dtype, str):
            compute_dtype = _DTYPES[compute_dtype]
        self.model = model
        self.optimizer = optimizer
        self._opt = opt
        self._crit = criterion or GPTPretrainingCriterion()
        self._fused_head = bool(fused_head)
        self._compute_dtype = compute_dtype
        self._layer_chunk = layer_chunk
        self._chunks = cfg.num_layers // layer_chunk
        self._blocks = blocks
        self._template = blocks._template
        self._s_params = blocks.stacked()
        self._outer = [(n, p) for n, p in model.named_parameters()
                       if "blocks__" not in n]
        self._o_params = [(n, p) for n, p in self._outer
                          if p.requires_grad]
        if compute_dtype is not None:
            for p in self._s_params + [p for _, p in self._o_params]:
                if p.dtype != torch.float32:
                    raise ValueError(
                        "compute_dtype expects fp32-stored params (the "
                        f"param IS the master); got {p.dtype}")
        self._dropout = float(cfg.hidden_dropout_prob or 0.0)
        # an MoE layer's aux loss weighs moe_aux_weight / L in the loss
        self._aux_w = (cfg.moe_aux_weight / cfg.num_layers
                       if cfg.num_experts else None)
        self._guard = (GuardSpec(scaler)
                       if (scaler is not None or guard_nonfinite) else None)
        self._guard_state = None
        self._numerics = None
        if numerics if numerics is not None else monitor_enabled():
            k, c = layer_chunk, self._chunks
            labels = [(f"chunk{i}(layer {i * k})" if k == 1 else
                       f"chunk{i}(layers {i * k}-{(i + 1) * k - 1})")
                      for i in range(c)] + ["outer"]
            self._numerics = NumericsMonitor(type(self).__name__, c + 1,
                                             row_labels=labels)

    # -- input pipeline --------------------------------------------------
    def prefetch(self, loader, depth=2, **kw):
        """``loader`` wrapped in an `io.DevicePrefetcher` that stages its
        batches on the model's device while the previous step runs."""
        kw.setdefault("device", self._s_params[0].device)
        return DevicePrefetcher(loader, depth=depth, **kw)

    # -- the pieces of the model, as functions of explicit leaves ------
    def _cc(self, t):
        """The compute-dtype view of an fp32-stored tensor (identity
        without ``compute_dtype``); autograd upcasts its grad."""
        cd = self._compute_dtype
        return t if cd is None else t.to(cd)

    def _embed(self, o, ids, pos):
        g = self.model.gpt
        x = (functional_call(g.wte, {"weight": self._cc(o["gpt.wte.weight"])},
                             (ids,))
             + functional_call(g.wpe,
                               {"weight": self._cc(o["gpt.wpe.weight"])},
                               (pos,)))
        if self._dropout:
            x = torch.nn.functional.dropout(x, self._dropout, training=True)
        return x

    def _chunk(self, layers, h, seg):
        """The chunk's layers, each over its leaves (one slice per stacked
        parameter, in the template's order)."""
        return self._chunk_aux(layers, h, seg)[0]

    def _chunk_aux(self, layers, h, seg):
        """`_chunk`'s (output, [each MoE layer's aux loss])."""
        auxs = []
        for leaves in layers:
            h = self._blocks.layer(h, seg, *[self._cc(t) for t in leaves])
            if self._aux_w is not None:
                h, aux = h
                auxs.append(aux)
        return h, auxs

    def _head(self, o, x, labels):
        from ..models.gpt import draft_head_loss, fused_lm_loss

        m = self.model
        h = functional_call(m.gpt.ln_f,
                            {"weight": self._cc(o["gpt.ln_f.weight"]),
                             "bias": self._cc(o["gpt.ln_f.bias"])}, (x,))
        w = self._cc(o["gpt.wte.weight"] if m.lm_head is None
                     else o["lm_head.weight"])
        if self._fused_head:
            loss = fused_lm_loss(h, w, True, labels)
        else:
            loss = self._crit(torch.nn.functional.linear(h, w), labels)
        if m.draft_heads is not None:
            # the heads are outer parameters: their grads ride the outer
            # pass's
            heads = [
                (lambda lin, p: lambda x: functional_call(lin, p, (x,)))(
                    lin, {"weight": self._cc(o[f"draft_heads.{j}.weight"]),
                          "bias": self._cc(o[f"draft_heads.{j}.bias"])})
                for j, lin in enumerate(m.draft_heads)]
            loss = loss + m.config.draft_head_loss_weight * draft_head_loss(
                m, h, w, True, labels, heads=heads)
        return loss

    # -- optimizer state ---------------------------------------------------
    def _state(self, params):
        """(masters, m, v) lists of ``params``, made at first use as the
        optimizer makes them."""
        opt = self._opt
        masters = [opt._master_weight(p) if opt._use_master(p) else None
                   for p in params]
        mv = [opt._state_of(p) for p in params]
        return masters, [s[0] for s in mv], [s[1] for s in mv]

    def _hyper(self, params):
        opt = self._opt
        return dict(lr_scales=[opt._param_lr_scale(p) for p in params],
                    wds=[opt._decoupled_wd(p) for p in params],
                    l2s=[opt._l2_coeff(p) for p in params],
                    need_clip=[getattr(p, "need_clip", True)
                               for p in params])

    # -- one step ----------------------------------------------------------
    def __call__(self, ids, labels, segment_ids=None):
        opt, K, C = self._opt, self._layer_chunk, self._chunks
        s_params = self._s_params
        dev = s_params[0].device
        train = [i for i, p in enumerate(s_params) if p.requires_grad]
        need = [getattr(s_params[i], "need_clip", True) for i in train] * K
        s_masters, s_m, s_v = self._state([s_params[i] for i in train])
        o_names = [n for n, _ in self._o_params]
        o_params = [p for _, p in self._o_params]
        o_masters, o_m, o_v = self._state(o_params)
        guard, nm = self._guard, self._numerics is not None
        scale = inv = None
        if guard is not None:
            if self._guard_state is None:
                self._guard_state = guard.init_state(dev)
            if guard.scaling:
                scale = self._guard_state["scale"]
                inv = torch.reciprocal(scale)
        ids = ids.long()
        labels = labels.long()
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        seg = segment_ids
        rng = bool(self._dropout)
        forked = [dev.index] if dev.type == "cuda" else []
        self._template.train()

        def leaves_of(params, grad):
            return {n: p.detach().requires_grad_(grad and p.requires_grad)
                    for n, p in params}

        def chunk_layers(c, grad):
            # one leaf a layer's slice (not a [K, ...] leaf indexed in the
            # graph: its grad would be a zero fill and a copy a parameter)
            return [[p.detach()[i].requires_grad_(grad and p.requires_grad)
                     for p in s_params] for i in range(c * K, (c + 1) * K)]

        def chunk_tensors(ts, c):
            """Chunk ``c``'s slices of ``ts`` (a stacked tensor per
            trainable parameter), layer by layer: the update's list."""
            return [None if t is None else t[i]
                    for i in range(c * K, (c + 1) * K) for t in ts]

        # 1. forward without autograd, keeping each chunk's input
        states, xs, auxs = [], [], []
        act_sq, act_origin = [], []
        with torch.no_grad():
            if rng:
                emb_state = _rng_state(dev)
            h = self._embed(leaves_of(self._outer, False), ids, pos)
            in_fin = torch.isfinite(h).all() if nm else None
            for c in range(C):
                if rng:
                    states.append(_rng_state(dev))
                xs.append(h)
                h, c_aux = self._chunk_aux(chunk_layers(c, False), h, seg)
                auxs += c_aux
                if nm:
                    sq = torch.linalg.vector_norm(
                        h, dtype=torch.float32).square()
                    out_fin = torch.isfinite(sq)
                    act_sq.append(sq)
                    act_origin.append(in_fin & ~out_fin)
                    in_fin = out_fin
        act_n = float(h.numel())

        # 2. the head with autograd
        o_leaves = leaves_of(self._outer, True)
        xL = h.requires_grad_()
        loss = self._head(o_leaves, xL, labels)
        head = torch.autograd.grad(
            loss, [xL] + [o_leaves[n] for n in o_names],
            grad_outputs=None if scale is None else scale.to(loss.dtype),
            allow_unused=True)
        dy, head_g = head[0], head[1:]
        del xL, o_leaves
        aux_ct = None
        if auxs:
            # the reported loss holds the forward's aux losses; their
            # cotangent goes into every chunk's grads
            loss = loss.detach() + self._aux_w * torch.stack(auxs).sum()
            aux_ct = torch.full((), self._aux_w, device=dev)
            if scale is not None:
                aux_ct = aux_ct * scale

        def chunk_grads(c, dy):
            """Chunk ``c`` recomputed with autograd from its input, under
            its forward's generator state: (its leaves' grads, dx)."""
            layers = chunk_layers(c, True)
            x = xs[c].detach().requires_grad_()
            with torch.random.fork_rng(devices=forked, enabled=rng):
                if rng:
                    _set_rng_state(dev, states[c])
                out, c_aux = self._chunk_aux(layers, x, seg)
            got = torch.autograd.grad(
                [out] + c_aux,
                [x] + [leaves[i] for leaves in layers for i in train],
                [dy] + [aux_ct.to(a.dtype) for a in c_aux])
            return list(got[1:]), got[0]

        def outer_grads(dx0):
            """The outer parameters' grads: the head's plus the
            embedding's (recomputed under its generator state)."""
            leaves = leaves_of(self._outer, True)
            used = [n for n in ("gpt.wte.weight", "gpt.wpe.weight")
                    if n in o_names]
            with torch.random.fork_rng(devices=forked, enabled=rng):
                if rng:
                    _set_rng_state(dev, emb_state)
                x0 = self._embed(leaves, ids, pos)
            emb = dict(zip(used, torch.autograd.grad(
                x0, [leaves[n] for n in used], dx0)))
            out = []
            for n, p, gh in zip(o_names, o_params, head_g):
                ge = emb.get(n)
                if gh is None or ge is None:
                    g = gh if ge is None else ge
                    g = torch.zeros_like(p) if g is None else g
                else:
                    g = gh + ge if p.dtype == torch.float32 else \
                        (gh.float() + ge.float()).to(p.dtype)
                out.append(g)
            return out

        o_need = [getattr(p, "need_clip", True) for p in o_params]
        clip_scale = found = grad_rows = og = None
        # 3. the clip's and the guard's first reverse pass
        if self._clip_global is not None or guard is not None:
            sq_clip, found_any, grad_rows = [], [], []
            for c in reversed(range(C)):
                g, dy = chunk_grads(c, dy)
                c_sq, c_found = _sq(g, need if self._clip_global is not None
                                    else None, inv)
                if nm:
                    all_sq = c_sq if (self._clip_global is None
                                      or all(need)) else _sq(g, None, inv)[0]
                    grad_rows.append((all_sq, c_found if guard is not None
                                      else ~torch.isfinite(all_sq)))
                sq_clip.append(c_sq)
                found_any.append(c_found)
                del g
            og = outer_grads(dy)
            o_sq, o_found = _sq(og, o_need, inv)
            if guard is not None:
                found = torch.stack(found_any + [o_found]).any()
            if self._clip_global is not None:
                total = torch.stack(sq_clip + [o_sq]).sum()
                norm = total.sqrt().clamp(min=1e-12)
                clip_scale = (torch.full((), self._clip_global,
                                         device=dev) / norm).clamp(max=1.0)
            grad_rows.reverse()
            dy = head[0]

        # 4. the update pass: each chunk's slices, in reverse
        lr = opt.get_lr()
        adam_kw = dict(lr=lr, beta1=opt._beta1, beta2=opt._beta2,
                       eps=opt._epsilon, step=opt._step_tensor(),
                       found_inf=found, clip_scale=clip_scale)
        s_hyper = {k: v * K for k, v in
                   self._hyper([s_params[i] for i in train]).items()}
        s_detached = [s_params[i].detach() for i in train]
        p_rows, u_rows, g_rows = [], [], []
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for c in reversed(range(C)):
            g, dy = chunk_grads(c, dy)
            xs[c] = None
            params = chunk_tensors(s_detached, c)
            masters = chunk_tensors(s_masters, c)
            if nm and grad_rows is None:
                c_sq, _ = _sq(g, None, inv)
                g_rows.append((c_sq, ~torch.isfinite(c_sq)))
            g_inv = self._value_clip(g, need, inv)
            values = [p if mw is None else mw
                      for p, mw in zip(params, masters)]
            if nm:
                p_rows.append(_sq(values)[0])
                old = [t.clone() for t in values]
            multi_tensor_adam(
                params, g, masters, chunk_tensors(s_m, c),
                chunk_tensors(s_v, c), inv_scale=g_inv, bump=False,
                **s_hyper, **adam_kw)
            del g
            if nm:
                torch._foreach_sub_(old, values)
                u = _sq(old)[0]
                u_rows.append(u if found is None
                              else torch.where(found, zero, u))
                del old

        # the outer parameters, once every layer is done: the step's last
        # update raises the count
        if og is None:
            og = outer_grads(dy)
        if nm:
            o_g_sq, _ = _sq(og, None, inv)
            o_values = [p.detach() if mw is None else mw
                        for p, mw in zip(o_params, o_masters)]
            o_p_sq = _sq(o_values)[0]
            o_old = [t.clone() for t in o_values]
        o_inv = self._value_clip(og, o_need, inv)
        multi_tensor_adam(
            [p.detach() for p in o_params], og, o_masters, o_m, o_v,
            inv_scale=o_inv, bump=True, **self._hyper(o_params), **adam_kw)
        if nm:
            torch._foreach_sub_(o_old, o_values)
            o_u_sq = _sq(o_old)[0]
            if found is not None:
                o_u_sq = torch.where(found, zero, o_u_sq)
            rows = grad_rows if grad_rows is not None else g_rows[::-1]
            stats = assemble_stats(
                torch.stack([r[0] for r in rows]),
                torch.stack(p_rows[::-1]), torch.stack(u_rows[::-1]),
                torch.stack(act_sq), torch.full((C,), act_n, device=dev),
                torch.stack([r[1] for r in rows]), torch.stack(act_origin),
                None,
                outer=outer_row(o_g_sq, o_p_sq, o_u_sq,
                                ~torch.isfinite(o_g_sq)))
            self._numerics.on_step(stats)

        # 5. the guard state and the scheduler
        if guard is not None:
            self._guard_state = guard.update(self._guard_state, found)
            guard.writeback(self._guard_state)
        sched = getattr(opt, "_learning_rate", None)
        if hasattr(sched, "step"):
            sched.step()
        return loss.detach()

    def _value_clip(self, grads, need, inv):
        """A ``ClipGradByValue`` clips the unscaled grads in place (the
        unscale written back, rounded as the update would round it);
        returns the inverse scale the update still has to apply."""
        if self._clip_value is None:
            return inv
        if inv is not None:
            multi_tensor_norm(grads, inv_scale=inv, write=True)
        lo, hi = self._clip_value
        for g, n in zip(grads, need):
            if n:
                g.clamp_(lo, hi)
        return None
