"""Pipeline model description: the port of paddle_tpu/distributed/fleet/
meta_parallel/pp_layers.py (:21-130).

`PipelineLayer` takes a list of `LayerDesc` (a layer made later), `
SharedLayerDesc` (a layer used by several entries, such as tied
embeddings), built layers and plain callables, and segments it into
stages by the reference's rule, bound for bound: "uniform" splits the
entries by count, "layer:ClassName" evenly over the layers of that
class. A rank builds **only its own stage's entries** (its stage is its
pipe coordinate in the fleet's topology): the memory contract of a
pipeline. Its parameters keep the reference's global names
(``_layers_list.{k}``, ``k`` the entry's index among the layer entries
of the whole list; a shared layer under its first entry's), so the union
of the ranks' state dicts has the reference's keys.

A `SharedLayerDesc` layer lives on each stage that uses it: at
construction the first such stage's parameters are broadcast to the
others, and `allreduce_shared_weight_gradients` sums its grads over
them (the reference's single controller holds one instance, so its own
is a no-op). A later stage's copy is marked ``is_stage_copy`` so a
global norm counts the weight once (`nn.clip.mp_norm_stats`).
"""
from __future__ import annotations

from torch import nn

from ... import collective as coll

__all__ = ["LayerDesc", "PipelineLayer", "SharedLayerDesc"]


class LayerDesc:
    """Reference pp_layers.py:21: a layer made when its stage is built."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("LayerDesc expects a Layer subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """Reference pp_layers.py:38: a layer shared between entries (and
    stages) under ``key``; ``forward_func(layer, *x)`` runs it where the
    entry is not its first use."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _type_name(d):
    if isinstance(d, LayerDesc):
        return d.layer_func.__name__
    return type(d).__name__


def _is_layer(d):
    return isinstance(d, (LayerDesc, nn.Module))


class PipelineLayer(nn.Module):
    """Reference pp_layers.py:51. ``num_stages`` defaults to the
    topology's (or the fleet's) pipe degree; ``stage_id`` to this rank's
    pipe coordinate (0 without a fleet)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None,
                 stage_id=None):
        super().__init__()
        from ..topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        self._loss_fn = loss_fn
        self._topo = topology
        self._recompute_interval = recompute_interval
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        if num_stages is None and hcg is not None:
            num_stages = hcg.get_pipe_parallel_world_size()
        self._num_stages = int(num_stages or 1)
        if stage_id is None:
            stage_id = (hcg.get_stage_id() if hcg is not None and
                        hcg.get_pipe_parallel_world_size()
                        == self._num_stages else 0)
        self._stage_id = int(stage_id)
        self._hcg = hcg
        self.descs = list(layers)
        for d in self.descs:
            if not (_is_layer(d) or callable(d)):
                raise TypeError(f"bad pipeline entry {d!r}")
        self.segment_parts = self._segment(seg_method)
        lo, hi = (self.segment_parts[self._stage_id],
                  self.segment_parts[self._stage_id + 1])

        # global layer index of each entry, and a shared key's first one
        self._layer_index, first, k = {}, {}, 0
        for i, d in enumerate(self.descs):
            if _is_layer(d):
                self._layer_index[i] = k
                if isinstance(d, SharedLayerDesc):
                    first.setdefault(d.layer_name, (i, k))
                k += 1
        self._layers_list = nn.Module()
        self._shared = {}
        built = []
        for i in range(lo, hi):
            d = self.descs[i]
            if isinstance(d, SharedLayerDesc):
                inst = self._shared.get(d.layer_name)
                if inst is None:
                    inst = self._shared[d.layer_name] = d.build_layer()
                    self._layers_list.add_module(
                        str(first[d.layer_name][1]), inst)
                fwd = d.forward_func if i != first[d.layer_name][0] \
                    else None
                built.append((inst, fwd))
            elif isinstance(d, LayerDesc):
                inst = d.build_layer()
                self._layers_list.add_module(str(self._layer_index[i]),
                                             inst)
                built.append((inst, None))
            elif isinstance(d, nn.Module):
                self._layers_list.add_module(str(self._layer_index[i]), d)
                built.append((d, None))
            else:
                built.append((d, None))
        self.run_function = built
        self._shared_groups = self._setup_shared(first)

    def _segment(self, method):
        """Stage boundaries (reference :89-106)."""
        n = len(self.descs)
        stages = self._num_stages
        if method == "uniform" or not method.startswith("layer:"):
            return [int(round(i * n / stages)) for i in range(stages + 1)]
        cls_name = method.split(":", 1)[1]
        idxs = [i for i, d in enumerate(self.descs)
                if _type_name(d) == cls_name]
        per = max(1, len(idxs) // stages)
        bounds = [0]
        for s in range(1, stages):
            bounds.append(idxs[min(s * per, len(idxs) - 1)])
        bounds.append(n)
        return bounds

    def _setup_shared(self, first):
        """{key: the group of this rank's copies} of each shared key that
        more than one stage uses (every rank builds every such group, in
        one order: ``new_group`` is collective); the first stage's
        parameters broadcast over it, the later copies marked."""
        groups = {}
        if self._num_stages == 1 or self._hcg is None:
            return groups
        uses = {}
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                uses.setdefault(d.layer_name, set()).add(
                    self.stage_of_layer(i))
        mesh = self._hcg.mesh
        for key in sorted(uses):
            stages = sorted(uses[key])
            if len(stages) < 2:
                continue
            for line in mesh.comm_lists(("pp",)):
                g = coll.new_group(ranks=[line[s] for s in stages])
                if g.rank >= 0 and key in self._shared:
                    groups[key] = g
        for key, g in groups.items():
            layer = self._shared[key]
            for p in layer.parameters():
                coll.broadcast(p.data, 0, g)
                if self._stage_id != min(uses[key]):
                    p.is_stage_copy = True
        return groups

    def stage_of_layer(self, i) -> int:
        for s in range(self._num_stages):
            if self.segment_parts[s] <= i < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def get_num_stages(self):
        return self._num_stages

    def get_stage_id(self):
        return self._stage_id

    def forward(self, *args):
        """This stage's entries over its input."""
        x = args if len(args) > 1 else args[0]
        for m, fwd in self.run_function:
            if fwd is not None:
                x = fwd(m, *(x if isinstance(x, tuple) else (x,)))
            elif isinstance(x, tuple):
                x = m(*x)
            else:
                x = m(x)
        return x

    def allreduce_shared_weight_gradients(self):
        """Sum each shared layer's grads over the stages that hold it."""
        for key, g in self._shared_groups.items():
            for p in self._shared[key].parameters():
                if p.grad is not None:
                    coll.all_reduce(p.grad, coll.ReduceOp.SUM, g)
