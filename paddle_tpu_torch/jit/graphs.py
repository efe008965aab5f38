"""CUDA graphs of the decode stack's steps: capture once, replay each call.

The port's counterpart of the reference's compiled step (``jax.jit`` over
a step function, paddle_tpu/jit/decode_step.py ``_Step``). Eager PyTorch
issues each of a decode step's kernels from the host, which costs more
than the kernels take on the card at serving batch sizes; a captured
``torch.cuda.CUDAGraph`` launches them all with one call.

* `StaticInputs`: the device tensors a graph reads. Before each replay
  `StaticInputs.load` refills one from a host array (an asynchronous
  copy) or from another device tensor.
* `StepGraphs`: one step's graphs, one a key (its input shapes), valid
  for one cache: a cache made anew (a recovered engine) drops them all.
  `StepGraphs.capture` first runs the step body once eagerly on a side
  stream (the warm-up: cuBLAS handles and workspaces, the split decode's
  counters, the allocator's blocks come into being outside the capture),
  then captures it on the same stream, with Python's cyclic collector
  held off during the capture (a graph of a dropped engine that the
  collector frees inside another capture invalidates that capture). The
  caller fills the static
  inputs for that warm-up with values that change nothing it keeps (all
  slots inactive, all chunk rows padding: their writes land on the trash
  page), or with the call's own inputs where the step can run twice (a
  generation prompt pass), or puts back what the warm-up moved (a dense
  decode's position), so the warm-up and the capture cost no extra
  step.
* The kernels count their launches in Python, which a replay does not
  run: a capture records how far it moved the counters of every kernel a
  decode-stack step can launch (the paged kernels', the weight-only
  linear's, the splash and flash forwards'), puts them back, and each
  replay adds that difference.

A failed capture or replay raises; nothing here falls back to the eager
loop. A graph's outputs live in its private memory pool and are
overwritten by its next replay.
"""
from __future__ import annotations

import contextlib
import gc
import weakref

import numpy as np
import torch

from ..ops.kernels import paged_attention
from ..ops.kernels.flash_attention import (flash_attention_fwd,
                                           flash_attention_fwd_single)
from ..ops.kernels.splash_attention import splash_attention_fwd
from ..ops.kernels.weight_only import weight_only_linear

__all__ = ["StaticInputs", "StepGraphs", "collector_held", "graph_of"]

# the launch counters, besides the paged kernels', that a step's graph
# can move: (wrapper, attribute)
_OTHER_COUNTERS = (
    (weight_only_linear, "launches_mma"),
    (weight_only_linear, "launches_wgmma"),
    (weight_only_linear, "launches_gemv"),
    (weight_only_linear, "launches_tiled"),
    (splash_attention_fwd, "launches"),
    (splash_attention_fwd, "launches_wgmma"),
    (flash_attention_fwd_single, "launches"),
    (flash_attention_fwd, "launches"),
    (flash_attention_fwd, "launches_wgmma"))


@contextlib.contextmanager
def collector_held():
    """No automatic collection of Python's cyclic garbage until the block
    ends (what it would have freed waits for the next collection):
    freeing a ``CUDAGraph`` (one of an engine that was dropped but sits
    in a reference cycle) inside a capture is an operation a capturing
    stream does not permit, and it invalidates the capture."""
    held = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if held:
            gc.enable()


def graph_of(fns):
    """One CUDA graph of the calls ``fns`` back to back, not yet
    replayed: each runs once eagerly on a side stream (the warm-up), then
    all are captured there with the cyclic collector held. A timing's
    graph: the launch counters move by the warm-up and the capture and
    not by a replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_held(), torch.cuda.graph(graph):
        for fn in fns:
            fn()
    return graph


def _counters():
    """A snapshot of every launch counter a step's graph can move,
    ``{(wrapper name, attribute): count}``."""
    return {**paged_attention.counters(),
            **{(w.__name__, a): getattr(w, a) for w, a in _OTHER_COUNTERS}}


def _add_counts(delta):
    """Add ``delta`` (keys as `_counters` gives them) to the counters."""
    paged_attention.add_counts(delta)
    for w, a in _OTHER_COUNTERS:
        n = delta.get((w.__name__, a), 0)
        if n:
            setattr(w, a, getattr(w, a) + n)

_NP_DTYPES = {torch.int32: np.int32, torch.int64: np.int64,
              torch.bool: np.bool_}


class StaticInputs:
    """Named device tensors at fixed addresses, which captured graphs
    read."""

    def __init__(self, device):
        self.device = device
        self._t = {}

    def __getitem__(self, name):
        return self._t[name]

    def load(self, name, value, dtype):
        """The static tensor ``name`` (made at ``value``'s shape on first
        use), holding ``value``: a host array or CPU tensor is copied in
        asynchronously, a device tensor on the device; the tensor itself
        is left as it is."""
        t = self._t.get(name)
        if value is t:
            return t
        if isinstance(value, torch.Tensor) and value.device.type != "cpu":
            src = value
        else:
            if isinstance(value, torch.Tensor):
                value = value.numpy()
            src = torch.from_numpy(np.ascontiguousarray(value,
                                                        _NP_DTYPES[dtype]))
        if t is None or t.shape != src.shape:
            t = torch.zeros(src.shape, dtype=dtype, device=self.device)
            self._t[name] = t
        t.copy_(src, non_blocking=True)
        return t


class _Graph:
    def __init__(self, graph, out, launches):
        self.graph = graph
        self.out = out
        self.launches = launches

    def replay(self):
        self.graph.replay()
        _add_counts(self.launches)
        return self.out


class StepGraphs:
    """The CUDA graphs of one step, one a key, for one cache."""

    def __init__(self):
        self._graphs = {}
        self._owner = None
        self._stream = None

    def __len__(self):
        return len(self._graphs)

    def lookup(self, key, cache):
        """The graph of ``key`` captured over ``cache``'s pools, or None.
        A graph holds its pools' addresses, so a lookup with another cache
        drops every graph."""
        if self._owner is None or self._owner() is not cache:
            self._graphs.clear()
            self._owner = weakref.ref(cache)
        return self._graphs.get(key)

    def capture(self, key, fn, device):
        """Run ``fn`` (the step body over the static inputs, returning its
        outputs) once eagerly on a side stream, then capture it there;
        returns the graph, not yet replayed."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side, cur = self._stream, torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)
        before = _counters()
        graph = torch.cuda.CUDAGraph()
        with collector_held():
            with torch.cuda.graph(graph, stream=side):
                out = fn()
        after = _counters()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        # the capture launched nothing
        _add_counts({k: -n for k, n in launches.items()})
        self._graphs[key] = g = _Graph(graph, out, launches)
        return g
