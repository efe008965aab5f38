"""The mixture-of-experts layer on one rank: the port of paddle_tpu/
incubate/distributed/models/moe/moe_layer.py.

`MoELayer` routes each token of ``x`` [..., d_model] to its gate's top-1
or top-2 experts (`gate`), runs the experts and sums their outputs by
the gate weights. The experts are `ExpertFFN`s (fc1, exact gelu, fc2);
their parameters are stacked on a leading ``E`` dim under the
reference's flat names, in the reference's (Paddle's) layout, so
`convert` carries them without a transpose:

* ``gate_weight`` ``[d_model, E]`` (the router; its logits are fp32 @
  fp32);
* ``experts__fc1__weight`` ``[E, d_model, d_hidden]``,
  ``experts__fc1__bias`` ``[E, d_hidden]``, ``experts__fc2__weight``
  ``[E, d_hidden, d_model]``, ``experts__fc2__bias`` ``[E, d_model]``.

An expert has ``capacity = max(1, ceil(cf * T / E))`` slots for the T
tokens of a call (T when ``capacity_factor`` is inf). The experts run as
one batched product over ``[E, C, ...]`` (``torch.baddbmm``: the
reference computes them in XLA, outside any Pallas kernel).

Dispatch and combine go by index (`moe_forward`): each kept (token,
choice) row is copied to its slot ``e * C + slot`` of an ``[E * C + 1,
d]`` buffer (a dropped one to the last row, a sink no expert reads), and
each token gathers its slots' outputs and sums them by its weights, in
fp32 (the weights rounded to the activations' dtype first, as the
reference's combine is). Fixed shapes, no ``nonzero`` and no host read,
so generation's CUDA graphs capture it. ``dense=True`` computes the
reference's way instead, dense ``[T, E, C]`` masks and two einsums: the
plain version the tests hold the index form against (at GPT-3 1.3B's
widths with 8 experts each mask is 134 M entries).

After a forward ``l_aux`` holds the load-balance aux loss; a caller that
needs it inside a recomputed region takes it from `forward_aux`'s
result instead.

Refused, naming ROADMAP A9b.3b (the ep axis): an ``ep_degree`` above 1,
an expert-parallel ``group`` of more than one rank or a ``mesh`` whose
``axis`` has a degree above 1, and `global_scatter` / `global_gather`.
`refuse_moe` is what the distributed entry points call on a model.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .....nn.layer.layers import create_parameter
from .gate import NaiveGate

__all__ = ["A9B3B", "ExpertFFN", "MoELayer", "expert_ffn", "global_gather",
           "global_scatter", "has_moe", "moe_forward", "refuse_moe"]

A9B3B = ("{} is not ported yet: ROADMAP A9b.3b (the ep axis: MoE over an "
         "expert-parallel group, and MoE models under the distributed "
         "steps)")

_STACKED = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")


class ExpertFFN(nn.Module):
    """The default expert: fc1, exact gelu, fc2 (the reference examples'
    expert; GPT's dense MLP takes the tanh gelu instead)."""

    def __init__(self, d_model, d_hidden, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_hidden, device=device, dtype=dtype)
        self.fc2 = nn.Linear(d_hidden, d_model, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def expert_ffn(xin, w1, b1, w2, b2):
    """Every expert over its slots: ``xin`` [E, C, d] -> [E, C, d], two
    batched products over the stacks."""
    h = F.gelu(torch.baddbmm(b1[:, None, :], xin, w1))
    return torch.baddbmm(b2[:, None, :], h, w2)


def moe_forward(xt, gate_weight, stacks, gate, capacity, dense=False):
    """The layer over the tokens ``xt`` [T, d]: ``(y [T, d], aux)``.
    ``stacks`` are the four expert stacks (module docstring), ``gate`` a
    `NaiveGate`; ``dense`` takes the reference's ``[T, E, C]`` form."""
    T, d = xt.shape
    E = gate_weight.shape[-1]
    logits = xt.float() @ gate_weight.float()
    if dense:
        combine, dispatch, aux = gate(logits, capacity)
        expert_in = torch.einsum("tec,th->ech", dispatch.to(xt.dtype), xt)
        out = expert_ffn(expert_in, *stacks)
        return torch.einsum("tec,ech->th", combine.to(xt.dtype), out), aux
    experts, slots, keep, weights, aux = gate.route(logits, capacity)
    k = experts.shape[1]
    dest = torch.where(keep, experts * capacity + slots,
                       E * capacity).reshape(-1)
    rows = xt[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = xt.new_zeros(E * capacity + 1, d).index_copy(0, dest, rows)
    out = expert_ffn(buf[:-1].view(E, capacity, d), *stacks)
    out = torch.cat([out.reshape(E * capacity, d), out.new_zeros(1, d)])
    picked = out.index_select(0, dest).view(T, k, d).float()
    w = weights.to(xt.dtype).float()
    return (picked * w[:, :, None]).sum(1).to(xt.dtype), aux


class MoELayer(nn.Module):
    """Mixture-of-experts over ``experts`` (`ExpertFFN`s of one shape,
    whose parameters are stacked at construction).

    Args:
      d_model: the token feature size.
      experts: the `ExpertFFN`s.
      gate: "gshard" (top-2), "switch" (top-1), "naive" (top-2) or a
        `NaiveGate`.
      capacity_factor: slots an expert = ``ceil(cf * T / E)``; inf keeps
        every token.
      axis, mesh, group, ep_degree: the reference's expert-parallel
        placement; above one rank they raise (module docstring).
    """

    def __init__(self, d_model, experts, gate="gshard",
                 capacity_factor=1.25, axis="ep", mesh=None, group=None,
                 ep_degree=None, device=None, dtype=None):
        super().__init__()
        self.d_model = int(d_model)
        self.num_experts = len(experts)
        if ep_degree is not None:
            ep_degree = int(ep_degree)
            if ep_degree < 1 or self.num_experts % ep_degree:
                raise ValueError(
                    f"num_experts {self.num_experts} not divisible by "
                    f"ep_degree {ep_degree}")
        mesh_deg = (getattr(mesh, "shape", None) or {}).get(axis, 1)
        if (ep_degree or 1) > 1 or mesh_deg > 1 or (
                group is not None and getattr(group, "nranks", 1) > 1):
            raise NotImplementedError(A9B3B.format(
                "MoELayer over an expert-parallel group"))
        self.ep_degree = ep_degree
        self.capacity_factor = capacity_factor
        self.gate = gate if isinstance(gate, NaiveGate) else NaiveGate(gate)
        for e in experts:
            if not (isinstance(getattr(e, "fc1", None), nn.Linear)
                    and isinstance(getattr(e, "fc2", None), nn.Linear)
                    and e.fc1.bias is not None and e.fc2.bias is not None):
                raise TypeError(
                    "MoELayer runs ExpertFFN experts (fc1, gelu, fc2 with "
                    f"biases) as batched products; got {type(e).__name__}")
        ref = experts[0].fc1.weight
        device = ref.device if device is None else device
        dtype = ref.dtype if dtype is None else dtype
        self.gate_weight = create_parameter(
            [self.d_model, self.num_experts], dtype=dtype, device=device)
        with torch.no_grad():
            for pname in _STACKED:
                parts = [e.get_parameter(pname) for e in experts]
                if pname.endswith("weight"):
                    parts = [t.t() for t in parts]   # Paddle's [in, out]
                self.register_parameter(
                    "experts__" + pname.replace(".", "__"),
                    nn.Parameter(torch.stack(parts).to(device=device,
                                                       dtype=dtype)))
        self.l_aux = None

    def stacks(self):
        """The four expert stacks (module docstring), in order."""
        return [getattr(self, "experts__" + n.replace(".", "__"))
                for n in _STACKED]

    def capacity(self, num_tokens):
        """Slots an expert has for ``num_tokens`` tokens."""
        if math.isinf(self.capacity_factor):
            return int(num_tokens)
        return max(1, int(math.ceil(self.capacity_factor * num_tokens
                                    / self.num_experts)))

    def forward_aux(self, x, dense=False):
        """``(y, aux)`` for ``x`` [..., d_model] (``dense``: the plain
        version); ``l_aux`` is set to aux."""
        if x.shape[-1] != self.d_model:
            raise ValueError(f"expected feature dim {self.d_model}, got "
                             f"{x.shape[-1]}")
        xt = x.reshape(-1, self.d_model)
        y, self.l_aux = moe_forward(
            xt, self.gate_weight, self.stacks(), self.gate,
            self.capacity(xt.shape[0]), dense=dense)
        return y.reshape(x.shape), self.l_aux

    def forward(self, x):
        return self.forward_aux(x)[0]


def has_moe(model) -> bool:
    """Whether ``model`` holds an `MoELayer`, in a scan stack's template
    block too."""
    for m in model.modules():
        template = getattr(m, "_template", None)
        for sub in [m] + (list(template.modules())
                          if isinstance(template, nn.Module) else []):
            if isinstance(sub, MoELayer):
                return True
    return False


def refuse_moe(model, what):
    """Raise for an MoE ``model`` at an entry point that would drop its
    aux loss or route a rank's tokens alone (``what`` names it)."""
    if has_moe(model):
        raise NotImplementedError(A9B3B.format(f"{what} with an MoE model"))


def global_scatter(x, local_count, global_count, group=None):
    """Reference moe_layer.py:389: the all-to-all token push of the ep
    axis."""
    raise NotImplementedError(A9B3B.format("global_scatter"))


def global_gather(x, local_count, global_count, group=None):
    """Reference moe_layer.py:413: its inverse."""
    raise NotImplementedError(A9B3B.format("global_gather"))
