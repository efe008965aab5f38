"""The hybrid-parallel topology: the port of paddle_tpu/distributed/fleet/
topology.py (:27-227).

`CommunicateTopology` is the coordinate arithmetic of the rank grid in
the order [pipe, data, sharding, sep, model]. `HybridCommunicateGroup`
installs that grid as the world's `env.RankMesh` and builds a group for
every axis (and the fused data group) on every rank, in the same order:
``torch.distributed.new_group`` is collective, so a rank that skipped
one would hang the others. This rank's coordinates come from its global
rank. The model (mp) and pipe (pp) axes take any degree: a rank's
stage is its pipe coordinate, its ring neighbours the ranks one stage
before and after it with the other coordinates fixed. The sep axis
(sequence blocks, `meta_parallel.SegmentParallel`) takes any degree: at
a degree above 1 it has its group and the fused dp+sep group
(`get_dp_sep_parallel_group`, over which the grads are reduced), as in
the reference (:117, :126-131); at degree 1 its group is None and the
dp+sep group is the dp group.
"""
from __future__ import annotations

import itertools

import numpy as np

from .. import collective as coll
from .. import env

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]

_AXIS_NAME = {"pipe": "pp", "data": "dp", "sharding": "sharding",
              "sep": "sep", "model": "mp"}

class CommunicateTopology:
    """Reference topology.py:66: coordinate math over the hybrid grid."""

    def __init__(self, hybrid_group_names=("pipe", "data", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*(range(d) for d in dims)))
        self._world_size = int(np.prod(dims))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}
        self._rank2coord = {v: k for k, v in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        return self._coord2rank[tuple(kwargs[n]
                                      for n in self._parallel_names)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        """Every rank whose coordinate on ``axis_name`` is ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        """The groups of ranks that vary ``axis_name`` with the other
        coordinates fixed."""
        axis = self._parallel_names.index(axis_name)
        other = [d for i, d in enumerate(self._dims) if i != axis]
        out = []
        for rest in itertools.product(*(range(d) for d in other)):
            ranks = []
            for v in range(self._dims[axis]):
                coord = list(rest)
                coord.insert(axis, v)
                ranks.append(self._coord2rank[tuple(coord)])
            out.append(ranks)
        return out

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for name, v in kwargs.items():
            coord[self._parallel_names.index(name)] = v
        return self._coord2rank[tuple(coord)]


class HybridCommunicateGroup:
    """Reference topology.py:178: per-axis degrees, this rank's
    coordinates, and a `collective.Group` per axis."""

    def __init__(self, topology: CommunicateTopology = None, mesh=None):
        if mesh is None:
            if topology is None:
                raise ValueError("need a topology or a mesh")
            mesh = env.build_mesh({_AXIS_NAME[n]: topology.get_dim(n)
                                   for n in
                                   topology.get_hybrid_group_names()})
        env.set_mesh(mesh)
        self._mesh = mesh
        if topology is None:
            topology = CommunicateTopology(dims=[
                mesh.shape.get(_AXIS_NAME[n], 1)
                for n in ("pipe", "data", "sharding", "sep", "model")])
        self._topo = topology
        deg = lambda a: int(mesh.shape.get(a, 1))  # noqa: E731
        self._dp_degree, self._mp_degree = deg("dp"), deg("mp")
        self._pp_degree, self._sep_degree = deg("pp"), deg("sep")
        self._sharding_degree = deg("sharding")
        self.global_rank = env.get_rank()
        # every axis group on every rank, in one order (reference :201-226)
        self._dp_group = self._make_group(("dp",))
        self._mp_group = self._make_group(("mp",))
        self._pp_group = self._make_group(("pp",))
        self._sharding_group = self._make_group(("sharding",))
        # the sep group and the fused dp+sep group (reference :117,
        # :126-131), only at a sep degree above 1, as there
        sep = self._sep_degree > 1
        self._sep_group = self._make_group(("sep",)) if sep else None
        self._dp_sep_group = (self._make_group(("dp", "sep")) if sep
                              else self._dp_group)
        data = env.data_axes(mesh)
        self._data_group = (self._make_group(data) if len(data) > 1
                            else self._dp_group if data == ("dp",)
                            else self._sharding_group)
        self._check_group = self._make_group(("pp", "mp"))

    def _make_group(self, axes):
        axes = tuple(a for a in axes if a in self._mesh.axis_names) \
            or (self._mesh.axis_names[0],)
        return coll.new_group(axes=axes, mesh=self._mesh)

    @property
    def mesh(self):
        return self._mesh

    def topology(self):
        return self._topo

    def get_hybrid_group_names(self):
        return self._topo.get_hybrid_group_names()

    def _index(self, axis):
        return self._mesh.axis_index(axis) if axis in self._mesh.shape \
            else 0

    # -- degrees and this rank's coordinates ------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_rank(self):
        return self._index("dp")

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_rank(self):
        return self._index("mp")

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_stage_id(self):
        return self._index("pp")

    def _stage_rank(self, stage):
        """The global rank at pipe coordinate ``stage`` (mod the degree),
        the other coordinates this rank's."""
        return self._pp_group.ranks[stage % self._pp_degree]

    def get_p2p_next_rank(self):
        return self._stage_rank(self.get_stage_id() + 1)

    def get_p2p_prev_rank(self):
        return self._stage_rank(self.get_stage_id() - 1)

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_rank(self):
        return self._index("sharding")

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_rank(self):
        return self._index("sep")

    # -- groups ----------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._dp_group

    def get_model_parallel_group(self):
        return self._mp_group

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_dp_sep_parallel_group(self):
        return self._dp_sep_group

    def get_sharding_data_group(self):
        """The group over every data axis of degree > 1 (dp and sharding
        flattened, dp major): what the sharded optimizer shards over."""
        return self._data_group

    def get_check_parallel_group(self, sharding=False):
        """The group over which the parameters differ (pp and mp): a
        global-norm clip sums over it and a non-finite flag is one flag
        over it (reference :197)."""
        return self._check_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1


_hcg = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group():
    return _hcg
