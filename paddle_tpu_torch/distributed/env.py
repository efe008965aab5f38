"""The distributed environment: the port of paddle_tpu/distributed/env.py.

A rank is a process. `init_parallel_env` joins this process to the world
over ``torch.distributed``: NCCL on ``cuda:LOCAL_RANK`` by default, gloo
on the CPU only when the caller asks for it (``backend="gloo"`` or
``device="cpu"``). ``backend="gloo", device="cuda"`` is an explicit
request that ranks share a card (rank's device ``cuda:LOCAL_RANK`` modulo
the cards there are: every rank on ``cuda:0`` on a one-card machine,
where NCCL refuses two ranks): its collectives run over the host
(`collective`), a harness for correctness, not a speed path. An NCCL
failure raises; nothing falls back to gloo or the CPU.

The world comes from the reference's environment contract
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``MASTER_ADDR`` /
``MASTER_PORT`` or ``PADDLE_MASTER``) or torchrun's (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``). With
none of them set the world is this process alone, on a local store, as
the reference's single-host call builds its one-axis mesh and joins no
one.

The reference's mesh becomes a `RankMesh`: the world's ranks laid out on
named axes in `AXIS_ORDER` (rank-major, the last axis fastest, as
``np.reshape`` of the device list lays out the reference's mesh), so the
rank at mesh coordinate ``c`` is the reference's device at ``c``.
`data_shard` hands a rank its rows of a global batch.
"""
from __future__ import annotations

import datetime
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXIS_ORDER", "RankMesh", "build_mesh", "data_axes",
           "data_shard", "get_backend", "get_device", "get_mesh",
           "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "reset", "set_mesh"]

# the reference topology's order [pipe, data, sharding, sep, model]
AXIS_ORDER = ("pp", "dp", "sharding", "sep", "mp")
DATA_AXES = ("dp", "sharding")

_lock = threading.Lock()
_state = {"initialized": False, "backend": None, "device": None,
          "rank": 0, "world_size": 1, "local_rank": 0, "mesh": None}


def _env_int(*names, default):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _init_method():
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if addr and port:
        return f"tcp://{addr}:{port}"
    master = os.environ.get("PADDLE_MASTER")
    if master:
        return f"tcp://{master}"
    return None


def init_parallel_env(backend=None, device=None, timeout=None,
                      init_method=None, rank=None, world_size=None):
    """Join the world (reference parallel.py:978). ``backend``: "nccl"
    (the default on the card) or "gloo" (the CPU; with ``device="cuda"``
    or ``"cuda:i"``, ranks sharing the card); ``device="cpu"`` asks for
    gloo too. ``timeout`` in seconds (or a ``timedelta``) bounds
    every collective. ``init_method`` / ``rank`` / ``world_size``
    override the environment (a ``file://`` store for spawned tests).
    Idempotent: a second call returns the device of the first."""
    with _lock:
        if _state["initialized"]:
            return _state["device"]
        rank = _env_int("RANK", "PADDLE_TRAINER_ID", default=0) \
            if rank is None else int(rank)
        world = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1) \
            if world_size is None else int(world_size)
        local_rank = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK",
                              default=rank % max(1, torch.cuda.device_count()))
        want = None if device is None else torch.device(device)
        if backend == "gloo" and want is not None and want.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("init_parallel_env: gloo on the card "
                                   "asked for, but no CUDA device")
            dev = want if want.index is not None else torch.device(
                "cuda", local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        elif backend == "gloo" or (want is not None and want.type == "cpu"):
            backend, dev = "gloo", torch.device("cpu")
        else:
            if backend not in (None, "nccl"):
                raise ValueError(f"unsupported backend {backend!r} "
                                 "(nccl on the card, gloo on the CPU)")
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init_parallel_env: no CUDA device for NCCL; pass "
                    "backend='gloo' or device='cpu' to run on the CPU")
            backend = "nccl"
            dev = torch.device("cuda", local_rank) if device is None \
                else torch.device(device)
            torch.cuda.set_device(dev)      # before the group exists
        if timeout is not None and not isinstance(timeout,
                                                  datetime.timedelta):
            timeout = datetime.timedelta(seconds=float(timeout))
        kw = {} if timeout is None else {"timeout": timeout}
        if backend == "nccl":
            kw["device_id"] = dev       # the communicator is made now
        if not dist.is_initialized():
            method = init_method or _init_method()
            if method is None:
                if world != 1:
                    raise RuntimeError(
                        f"a world of {world} ranks needs MASTER_ADDR / "
                        "MASTER_PORT (or PADDLE_MASTER, or init_method=)")
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1, **kw)
            else:
                dist.init_process_group(backend, init_method=method,
                                        rank=rank, world_size=world, **kw)
        _state.update(initialized=True, backend=backend, device=dev,
                      rank=dist.get_rank(), world_size=dist.get_world_size(),
                      local_rank=local_rank,
                      mesh=RankMesh({"dp": dist.get_world_size()}))
        return dev


def is_initialized() -> bool:
    return _state["initialized"]


def _require():
    if not _state["initialized"]:
        init_parallel_env()


def get_rank() -> int:
    return _state["rank"] if _state["initialized"] else 0


def get_world_size() -> int:
    return _state["world_size"] if _state["initialized"] else 1


def get_device() -> torch.device:
    """This rank's device (``cuda:LOCAL_RANK``, or the CPU under gloo)."""
    _require()
    return _state["device"]


def get_backend() -> str:
    _require()
    return _state["backend"]


def reset():
    """Leave the world: destroy the process group and forget the mesh and
    the fleet's topology (tests that run several worlds in one process)."""
    from . import collective

    with _lock:
        if dist.is_initialized():
            dist.destroy_process_group()
        _state.update(initialized=False, backend=None, device=None, rank=0,
                      world_size=1, local_rank=0, mesh=None)
    collective._reset()
    try:
        from .fleet import topology
    except ImportError:
        return
    topology.set_hybrid_communicate_group(None)


class RankMesh:
    """The world's ranks on named axes: ``shape`` maps each axis to its
    degree, ``ranks`` is the rank grid (``np.ndarray`` of global ranks,
    one dim an axis), and `coord` / `axis_index` give a rank's place on
    it. Degree-1 axes are kept so code can name them uniformly."""

    def __init__(self, degrees: dict):
        names = [a for a in AXIS_ORDER if a in degrees]
        names += [a for a in degrees if a not in names]
        self.axis_names = tuple(names)
        self.shape = {a: int(degrees[a]) for a in names}
        size = int(np.prod(list(self.shape.values()))) if names else 1
        self.size = size
        self.ranks = np.arange(size).reshape(
            [self.shape[a] for a in names])
        self._groups = {}        # axes -> Group (built collectively)

    def coord(self, rank=None):
        rank = get_rank() if rank is None else rank
        return tuple(int(c) for c in np.unravel_index(rank,
                                                      self.ranks.shape))

    def axis_index(self, axis, rank=None):
        """``rank``'s (default: this process's) index on ``axis``; a
        tuple of axes flattens first-axis-major."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        c = self.coord(rank)
        r = 0
        for a in axes:
            r = r * self.shape[a] + c[self.axis_names.index(a)]
        return r

    def degree(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def comm_lists(self, axes):
        """Every group of ranks that varies over ``axes`` with the other
        coordinates fixed, in mesh order (each rank list first-axis-
        major over ``axes``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        grid = np.transpose(self.ranks, rest + keep)
        return [list(map(int, row))
                for row in grid.reshape(-1, self.degree(axes))]

    def __repr__(self):
        return f"RankMesh({self.shape})"


def build_mesh(degrees: dict) -> RankMesh:
    """A mesh over the world from axis name -> degree, in `AXIS_ORDER`
    with unknown axes appended. Its size must be the world's."""
    mesh = RankMesh(degrees)
    world = get_world_size()
    if is_initialized() and mesh.size != world:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the "
                         f"world has {world}")
    return mesh


def set_mesh(mesh: RankMesh):
    _require()
    if mesh.size != get_world_size():
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks, the "
                         f"world {get_world_size()}")
    _state["mesh"] = mesh


def get_mesh() -> RankMesh:
    _require()
    return _state["mesh"]


def data_axes(mesh=None, axis=None):
    """The batch axes: ``axis`` as given, else the mesh's dp and sharding
    axes of degree > 1 (first-axis-major), else ()."""
    mesh = mesh or get_mesh()
    if axis is not None:
        return (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in mesh.axis_names
                 if a in DATA_AXES and mesh.shape[a] > 1)


def data_shard(batch, axis=None, mesh=None):
    """This rank's rows of a global ``batch`` (a tensor, an array, or a
    list / tuple / dict of them): dim 0 split evenly over the batch axes
    (`data_axes`), block ``r`` to the rank at index ``r`` on them, as the
    reference's data sharding places block ``r`` on device ``r``."""
    mesh = mesh or get_mesh()
    axes = data_axes(mesh, axis)
    n = mesh.degree(axes) if axes else 1
    r = mesh.axis_index(axes) if axes else 0

    def cut(x):
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} does not split over "
                             f"{n} ranks")
        b = x.shape[0] // n
        return x[r * b:(r + 1) * b]

    return cut(batch)
