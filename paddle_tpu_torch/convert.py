"""Carry parameters and optimizer state between the JAX package and the
port.

The reference's parameters come across keyed by its ``state_dict()``
names (parameters and persistable buffers, such as batch norm's
``_mean`` and ``_variance``), which the port's modules keep. One layout
differs: a Paddle ``Linear.weight`` is ``[in, out]``, a
``torch.nn.Linear.weight`` is ``[out, in]``, so every Linear weight is
transposed on the way in and back on the way out. Given the port's
model, the Linear weights are exactly the ``.weight`` of each
``torch.nn.Linear`` in it, and the stacked weight of each Linear of a
scan model's template block (`models.gpt.GPTStackedBlocks`: the
reference's ``[L, in, out]``, the port's ``[L, out, in]``: the last two
axes swap); without one, the names of GPT's and LLaMA's Linear layers
(``qkv``, ``out_proj``, ``fc1``, ``fc2``, their stacked
``blocks__..._weight``, ``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``,
``gate_proj``, ``up_proj``, ``down_proj``, the untied ``lm_head`` and
GPT's ``draft_heads.{j}``) decide. Everything else crosses as it is, among it a quantized model's
``quant_weight`` (int8 ``[out, in]`` on both sides, after
`nn.quant.quantize_for_decode`), ``weight_scale`` and ``bias``, and an
MoE layer's expert stacks (``experts__fc1__weight`` /
``experts__fc2__weight``: ``[E, in, out]``, ``[L, E, in, out]`` in a
scan model, the reference's layout on both sides, which the batched
products read as they are; they are no ``torch.nn.Linear``).
The round trip is bit-exact.

Tensor parallelism: a rank of a model-parallel group holds blocks of
some parameters (the `distributed.fleet.layers.mpu` layers, the sliced
leaves of the dp x mp sharded scan). `mp_block` cuts rank r's block
from a global tensor by its kind (``("split", dim)``: a contiguous
block; ``("heads", dim, heads, head_dim)``: the rank's heads of a fused
q|k|v dim) and `mp_join` puts the ranks' blocks back, bit for bit;
`mp_state_dict_from_jax` / `mp_state_dict_to_jax` carry the reference's
global arrays into rank r's blocks and the ranks' state dicts back into
the reference's arrays (`mp_plan` reads a model's kinds from its
parameters' ``split_axis``);
`optimizer_state_from_jax` with ``rank`` / ``degree`` cuts the moments
and masters as their parameters, and `mp_optimizer_state_to_jax` joins
the ranks' optimizer states back.

Pipeline parallelism: a rank of a pipeline group holds its stage.
`pipe_stage_from_jax` cuts a `models.GPTForCausalLMPipe` rank's slice
``[stage:stage + 1]`` of the reference's stacked ``[n_stages, ...]``
blocks (the embeddings and ln_f whole) and `pipe_stage_to_jax` joins the
ranks' state dicts back along that dim; `pipeline_state_dict_from_jax`
gives a `PipelineLayer` rank the entries it holds of the reference's
named arrays (under mp, with ``rank`` / ``degree``, its blocks of them)
and `pipeline_state_dict_to_jax` joins the ranks' (whose
keys are global) into them, bit for bit.

bf16 crosses as its raw 16-bit pattern: into the port as a torch
bfloat16 view, and out as numpy ``ml_dtypes.bfloat16`` where the caller's
process has loaded ``ml_dtypes`` (the JAX package does), else as a
`framework.io.Bfloat16Bits` array (uint16 bits marked as bf16), which
`framework.io.save` writes as the reference's bf16 arrays. Nothing here
imports ``ml_dtypes``.

Optimizer state: the reference keys a parameter's accumulators and
master weight by ``p.name``, ``param_<counter>`` from a process-wide
counter that each new parameter takes in the order it is created. The
port keys them by `optimizer.Optimizer._key`. `optimizer_state_from_jax`
/ `optimizer_state_to_jax` map one onto the other through the model:
the file's keys in the rank order of their counters are the model's
``named_parameters()`` in order (on the way out, ``names`` ({state-dict
name: reference ``p.name``}) may give the keys). The port's models
register their parameters in the order the reference creates them (a
ResNet block its ``downsample`` first), so the two orders agree; every
state's shape is checked against its parameter's. A Linear weight's
moments and master are transposed as the weight is; the step count and
the ``LR_Scheduler`` state cross as they are.
"""
from __future__ import annotations

import re
import sys

import numpy as np
import torch

from .framework.io import Bfloat16Bits

__all__ = ["linear_weights", "mp_block", "mp_join",
           "mp_optimizer_state_to_jax", "mp_plan", "mp_state_dict_from_jax", "mp_state_dict_to_jax",
           "pipe_stage_from_jax", "pipe_stage_to_jax",
           "pipeline_state_dict_from_jax", "pipeline_state_dict_to_jax",
           "optimizer_state_from_jax", "optimizer_state_to_jax",
           "state_dict_from_jax", "state_dict_to_jax"]

_LINEAR_WEIGHT = re.compile(
    r"(\.(qkv|out_proj|fc1|fc2|q_proj|k_proj|v_proj|o_proj|gate_proj"
    r"|up_proj|down_proj)|^lm_head|^draft_heads\.\d+)\.weight$"
    r"|(?<!experts)__(qkv|out_proj|fc1|fc2)__weight$")
_COUNTER_KEY = re.compile(r"^param_(\d+)$")


def _to_torch(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    bf16 = isinstance(a, Bfloat16Bits) or np.asarray(a).dtype.name == \
        "bfloat16"
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    if bf16:
        # numpy has no bf16 of its own (the reference's comes from
        # ml_dtypes): cross as the raw 16-bit pattern
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        ml_dtypes = sys.modules.get("ml_dtypes")
        if ml_dtypes is not None:
            return bits.view(ml_dtypes.bfloat16)
        return bits.view(Bfloat16Bits)
    return t.numpy()


def linear_weights(model=None, names=()) -> set:
    """The state-dict names of the Linear weights: the ``.weight`` of
    each ``torch.nn.Linear`` in ``model`` and the stacked weight of each
    ``torch.nn.Linear`` of a stacked template block in it, or, without a
    model, those of ``names`` that GPT's and LLaMA's Linear layers
    have."""
    if model is None:
        return {n for n in names if _LINEAR_WEIGHT.search(n)}
    out = set()
    for prefix, m in model.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(m, torch.nn.Linear):
            out.add(f"{dot}weight")
        template = getattr(m, "_template", None)
        if isinstance(template, torch.nn.Module):
            out.update(f"{dot}blocks__" + f"{lin}.weight".replace(".", "__")
                       for lin, sub in template.named_modules()
                       if isinstance(sub, torch.nn.Linear))
    return out


def _swap(t):
    """A Linear weight (or a stack of them) in the other layout."""
    return t.transpose(-2, -1)


def _check_shapes(model, tensors):
    """Each tensor's shape against the model's entry of that name."""
    want = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    for name, t in tensors.items():
        if name not in want:
            raise KeyError(f"{name}: not in the model's state dict")
        if tuple(t.shape) != want[name]:
            raise ValueError(
                f"{name}: shape {tuple(t.shape)} after the layout map, the "
                f"model's is {want[name]}")


def state_dict_from_jax(named, model=None) -> dict[str, torch.Tensor]:
    """{reference state-dict name: array or tensor} -> a state dict for
    the port's ``model`` (``load_state_dict``); CPU tensors, copied. With
    ``model``, its Linear weights are transposed and every shape is
    checked against it."""
    transpose = linear_weights(model, named)
    out = {}
    for name, arr in named.items():
        t = _to_torch(arr)
        if name in transpose:
            t = _swap(t)
        out[name] = t.contiguous().clone()
    if model is not None:
        _check_shapes(model, out)
    return out


def state_dict_to_jax(state_dict, model=None, tensors=False) -> dict:
    """The inverse of `state_dict_from_jax`: the port's state dict ->
    {reference name: numpy array} in the reference's layouts (with
    ``tensors``, CPU tensors in those layouts, which `framework.io.save`
    writes as the reference's tensor payloads)."""
    transpose = linear_weights(model, state_dict)
    out = {}
    for name, t in state_dict.items():
        if name in transpose:
            t = _swap(t)
        out[name] = (t.detach().cpu().contiguous() if tensors
                     else _to_numpy(t))
    return out


def _reference_names(model, names):
    """{port parameter: reference key} for ``model``: ``names`` maps its
    state-dict names to the reference's ``p.name``; without it, the rank
    in ``named_parameters()`` names them ``param_<rank>``, as a process
    that builds the model first numbers them."""
    order = list(model.named_parameters())
    if names is None:
        return {p: f"param_{i}" for i, (_, p) in enumerate(order)}
    missing = [n for n, _ in order if n not in names]
    if missing:
        raise KeyError(f"names= lacks parameters {missing}")
    return {p: names[n] for n, p in order}


def _state_keys(state):
    keys = set(state.get("master_weights", {}))
    for store in state.get("accumulators", {}).values():
        keys.update(store)
    return keys


def optimizer_state_from_jax(state, model, optimizer, rank=0,
                             degree=1) -> dict:
    """A reference ``Optimizer.state_dict()`` (as `framework.io.load`
    gives it) -> a state dict for the port's ``optimizer.set_state_dict``
    over ``model``. Keys that name no parameter (NAdam's ``_global``)
    cross as they are; the parameter keys must number the model's
    parameters exactly. Under tensor parallelism (``degree`` above 1)
    ``model`` is rank ``rank``'s and each parameter's state is cut to
    its block as the parameter is (`mp_plan`)."""
    plan = mp_plan(model)
    order = list(model.named_parameters())
    transpose = linear_weights(model)
    counted = sorted((int(m.group(1)), k) for k in _state_keys(state)
                     if (m := _COUNTER_KEY.match(k)))
    if len(counted) != len(order):
        raise ValueError(
            f"the state holds {len(counted)} parameters' keys, the "
            f"model has {len(order)} parameters")
    ref = {k: pair for (_, k), pair in zip(counted, order)}

    def cross(key, value):
        if key not in ref:
            return key, _to_torch(value)
        name, p = ref[key]
        t = _to_torch(value)
        if name in transpose:
            t = _swap(t)
        t = mp_block(t, plan.get(name), rank, degree)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name} ({key}): state of shape "
                             f"{tuple(t.shape)}, the parameter's is "
                             f"{tuple(p.shape)}")
        return optimizer._key(p), t.contiguous().clone()

    out = {"accumulators": {
               acc: dict(cross(k, v) for k, v in store.items())
               for acc, store in state.get("accumulators", {}).items()},
           "master_weights": dict(
               cross(k, v) for k, v in state.get("master_weights",
                                                 {}).items()),
           "step": state.get("step", 0)}
    if "LR_Scheduler" in state:
        out["LR_Scheduler"] = dict(state["LR_Scheduler"])
    return out


def optimizer_state_to_jax(state, model, optimizer, names=None) -> dict:
    """The inverse of `optimizer_state_from_jax`: the port's
    ``optimizer.state_dict()`` -> the reference's, keyed by ``names``
    ({state-dict name: the reference model's ``p.name``}) or by
    ``param_<rank in named_parameters()>``, numpy leaves in the
    reference's layouts."""
    find = optimizer._lookup()
    ref = _reference_names(model, names)
    by_param = {p: n for n, p in model.named_parameters()}
    transpose = linear_weights(model)

    def cross(key, value):
        p = find(key)
        if not isinstance(p, torch.Tensor):
            return key, _to_numpy(value)
        name = by_param.get(p)
        if name is None:
            raise KeyError(f"{key}: the optimizer's parameter is not in "
                           f"the model")
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name} ({key}): state of shape "
                             f"{tuple(value.shape)}, the parameter's is "
                             f"{tuple(p.shape)}")
        if name in transpose:
            value = _swap(value)
        return ref[p], _to_numpy(value)

    out = {"accumulators": {
               acc: dict(cross(k, v) for k, v in store.items())
               for acc, store in state.get("accumulators", {}).items()},
           "master_weights": dict(
               cross(k, v) for k, v in state.get("master_weights",
                                                 {}).items()),
           "step": state.get("step", 0)}
    if "LR_Scheduler" in state:
        out["LR_Scheduler"] = dict(state["LR_Scheduler"])
    return out


# ---------------------------------------------------------------------------
# tensor-parallel blocks
# ---------------------------------------------------------------------------

def mp_block(t, kind, rank, degree):
    """Rank ``rank``'s block of the port-layout tensor ``t`` split over
    ``degree`` ranks by ``kind`` (module docstring; None: the whole
    tensor, replicated). A view where the block is one."""
    if kind is None or degree == 1:
        return t
    if kind[0] == "split":
        dim = kind[1]
        w = t.shape[dim] // degree
        return t.narrow(dim, rank * w, w)
    _, dim, heads, hd = kind
    loc = heads // degree
    lead, rest = tuple(t.shape[:dim]), tuple(t.shape[dim + 1:])
    k = t.shape[dim] // (heads * hd)
    v = t.reshape(lead + (k, heads, hd) + rest)
    v = v.narrow(dim + 1, rank * loc, loc)
    return v.reshape(lead + (k * loc * hd,) + rest)


def mp_join(blocks, kind):
    """The inverse of `mp_block`: the global tensor from the ranks'
    blocks, in rank order."""
    degree = len(blocks)
    if kind is None or degree == 1:
        return blocks[0]
    if kind[0] == "split":
        return torch.cat(list(blocks), dim=kind[1])
    _, dim, heads, hd = kind
    loc = heads // degree
    b0 = blocks[0]
    lead, rest = tuple(b0.shape[:dim]), tuple(b0.shape[dim + 1:])
    k = b0.shape[dim] // (loc * hd)
    parts = [b.reshape(lead + (k, loc, hd) + rest) for b in blocks]
    return torch.cat(parts, dim=dim + 1).reshape(
        lead + (k * heads * hd,) + rest)


def mp_plan(model):
    """{state-dict name: kind} of ``model``'s parameters that are blocks
    (those with a ``split_axis``: the mpu layers')."""
    return {n: ("split", p.split_axis) for n, p in model.named_parameters()
            if getattr(p, "split_axis", None) is not None}


def mp_state_dict_from_jax(named, model, rank, degree, plan=None) -> dict:
    """The reference's global arrays -> a state dict of rank ``rank``'s
    blocks for ``model`` (built on that rank: its blocks' shapes are
    checked), the Linear weights transposed first."""
    plan = mp_plan(model) if plan is None else plan
    transpose = linear_weights(model, named)
    out = {}
    for name, arr in named.items():
        t = _to_torch(arr)
        if name in transpose:
            t = _swap(t)
        out[name] = mp_block(t, plan.get(name), rank, degree) \
            .contiguous().clone()
    _check_shapes(model, out)
    return out


def mp_state_dict_to_jax(state_dicts, model, plan=None) -> dict:
    """The inverse of `mp_state_dict_from_jax`: every rank's state dict
    (in rank order) -> {reference name: numpy array} of the global
    parameters, in the reference's layouts."""
    plan = mp_plan(model) if plan is None else plan
    joined = {name: mp_join([sd[name].detach().cpu() for sd in state_dicts],
                            plan.get(name))
              for name in state_dicts[0]}
    return state_dict_to_jax(joined, model)


def mp_optimizer_state_to_jax(states, models, optimizers,
                              names=None) -> dict:
    """The inverse of `optimizer_state_from_jax` under tensor
    parallelism: every rank's optimizer state (rank order, each with its
    model and optimizer) -> the reference's, each parameter's state
    joined from the ranks' blocks as the parameter is (`mp_plan`)."""
    model = models[0]
    plan = mp_plan(model)
    parts = [optimizer_state_to_jax(st, m, o, names)
             for st, m, o in zip(states, models, optimizers)]
    ref = _reference_names(model, names)
    named = {ref[p]: n for n, p in model.named_parameters()}
    transpose = linear_weights(model)

    def join(key, arrays):
        kind = plan.get(named.get(key))
        if kind is None or len(arrays) == 1:
            return arrays[0]
        dim = kind[1]
        if named[key] in transpose:
            dim = 1 - dim
        out = np.concatenate([np.asarray(a) for a in arrays], axis=dim)
        return out.view(type(arrays[0])) if isinstance(
            arrays[0], Bfloat16Bits) else out

    def joined(stores):
        return {k: join(k, [st[k] for st in stores]) for k in stores[0]}

    out = dict(parts[0])
    out["accumulators"] = {
        acc: joined([p["accumulators"][acc] for p in parts])
        for acc in parts[0].get("accumulators", {})}
    out["master_weights"] = joined([p.get("master_weights", {})
                                    for p in parts])
    return out


def pipe_stage_from_jax(named, model, stage=None) -> dict:
    """The reference's `GPTForCausalLMPipe` arrays -> a state dict of the
    port's ``model`` (a `models.GPTForCausalLMPipe` rank): its stage's
    slice ``[stage:stage + 1]`` of every stacked ``blocks__`` array
    (default ``model.stage``), the rest whole; Linear weights
    transposed."""
    stage = model.stage if stage is None else int(stage)
    cut = {k: (np.asarray(v)[stage:stage + 1] if k.startswith("blocks__")
               else v) for k, v in named.items()}
    return state_dict_from_jax(cut, model=model)


def pipe_stage_to_jax(state_dicts, model) -> dict:
    """The ranks' state dicts (stage order) of a `GPTForCausalLMPipe`
    -> the reference's named arrays: the stacked blocks joined along the
    stage dim, the rest from the first."""
    parts = [state_dict_to_jax(sd, model=model) for sd in state_dicts]
    return {k: (np.concatenate([p[k] for p in parts])
                if k.startswith("blocks__") else v)
            for k, v in parts[0].items()}


def pipeline_state_dict_from_jax(named, model, rank=0, degree=1) -> dict:
    """The entries of the reference's `PipelineLayer` named arrays that
    the rank's ``model`` holds (its keys are the reference's); under
    tensor parallelism (``degree`` above 1) model-parallel rank
    ``rank``'s blocks of them (`mp_state_dict_from_jax`)."""
    keys = set(model.state_dict())
    held = {k: v for k, v in named.items() if k in keys}
    if degree > 1:
        return mp_state_dict_from_jax(held, model, rank, degree)
    return state_dict_from_jax(held, model=model)


def pipeline_state_dict_to_jax(state_dicts, models) -> dict:
    """The ranks' `PipelineLayer` state dicts (each with its model) ->
    the reference's named arrays: their union (a shared layer's copies
    are alike; the first stage's is taken)."""
    out = {}
    for sd, m in zip(state_dicts, models):
        for k, v in state_dict_to_jax(sd, model=m).items():
            out.setdefault(k, v)
    return out
