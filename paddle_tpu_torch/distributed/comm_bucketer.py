"""Bucketed gradient collectives: the port of paddle_tpu/distributed/
comm_bucketer.py (:47-317).

Per-parameter grads coalesce into size-capped flat buckets and sync as
ONE collective a bucket. The assignment is the reference's, entry for
entry (`build_buckets`): the given order, one dtype a bucket, a new
bucket when the ``FLAGS_comm_bucket_mb`` cap would be passed (an
oversized tensor gets a bucket of its own), each bucket's flat length
padded up to ``pad_multiple`` (the group's degree for a reduce-scatter)
with zeros. The optimizer's shards and the sharded scan step's are
addressed by it as (bucket, offset, numel).

`GradBucketer` is the reference's explicit mode over a model's trainable
parameters: one flat buffer a bucket, one ``reduce_scatter`` (stage 2:
the rank keeps its 1/N shard of each bucket and the full grads go) or
one ``all_reduce`` (data parallelism: the mean written back into each
grad) a bucket. A bf16 or fp16 bucket is summed in fp32 and rounded
back once, as the reference sums its bf16 grads in fp32.

`bucketed_all_reduce` sums a list of tensors in place, one all-reduce a
bucket (compressed per ``FLAGS_comm_quant``); `bucketed_reduce_scatter`
gives this rank's shard of each bucket's sum. The reference's
``count_hlo_collectives`` counts collectives in compiled HLO; here
`collective.calls` counts the calls themselves.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import flags as _flags
from . import collective as coll

__all__ = ["MB", "Bucket", "BucketAssignment", "BucketEntry",
           "GradBucketer", "bucketed_all_reduce", "bucketed_reduce_scatter",
           "build_buckets", "default_bucket_bytes", "pack", "unpack"]

MB = 1 << 20
_NAMED = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "int8": torch.int8}


def _dtype(d):
    if isinstance(d, torch.dtype):
        return d
    return _NAMED[np.dtype(d).name if not isinstance(d, str) else d]


def _itemsize(d):
    return torch.empty((), dtype=d).element_size()


class BucketEntry(NamedTuple):
    key: object       # parameter name (or index for anonymous tensors)
    offset: int       # flat offset inside the bucket
    numel: int
    shape: tuple


class Bucket(NamedTuple):
    index: int
    dtype: torch.dtype    # shared by every entry
    entries: tuple        # tuple[BucketEntry]
    numel: int            # padded flat length (a multiple of pad_multiple)

    @property
    def keys(self):
        return [e.key for e in self.entries]

    @property
    def nbytes(self):
        return self.numel * _itemsize(self.dtype)


class BucketAssignment(NamedTuple):
    buckets: tuple        # tuple[Bucket]
    bucket_bytes: int
    pad_multiple: int

    def bucket_of(self, key):
        for b in self.buckets:
            for e in b.entries:
                if e.key == key:
                    return b, e
        raise KeyError(key)

    def describe(self):
        return [{"bucket": b.index, "dtype": str(b.dtype).split(".")[-1],
                 "numel": b.numel, "bytes": b.nbytes, "params": b.keys}
                for b in self.buckets]


def default_bucket_bytes():
    return int(_flags.get_flag("FLAGS_comm_bucket_mb") or 0) * MB


def build_buckets(named_shapes, bucket_bytes=None, pad_multiple=1):
    """Greedy packing of ``(key, shape, dtype)`` in the given order: a
    new bucket when the dtype changes or the cap would be passed (a
    single oversized tensor still gets its own; a cap of 0 gives one
    tensor a bucket), each bucket padded up to ``pad_multiple``. The
    reference's assignment, entry for entry."""
    if bucket_bytes is None:
        bucket_bytes = default_bucket_bytes()
    bucket_bytes = max(int(bucket_bytes), 1)
    pad_multiple = max(int(pad_multiple), 1)
    buckets = []
    cur, cur_dtype, cur_numel = [], None, 0

    def close():
        nonlocal cur, cur_dtype, cur_numel
        if not cur:
            return
        padded = -(-cur_numel // pad_multiple) * pad_multiple
        buckets.append(Bucket(len(buckets), cur_dtype, tuple(cur), padded))
        cur, cur_dtype, cur_numel = [], None, 0

    for key, shape, dtype in named_shapes:
        dtype = _dtype(dtype)
        numel = int(np.prod(shape)) if len(shape) else 1
        nbytes = numel * _itemsize(dtype)
        if cur and (dtype != cur_dtype or
                    cur_numel * _itemsize(cur_dtype) + nbytes
                    > bucket_bytes):
            close()
        cur_dtype = dtype
        cur.append(BucketEntry(key, cur_numel, numel, tuple(shape)))
        cur_numel += numel
    close()
    return BucketAssignment(tuple(buckets), bucket_bytes, pad_multiple)


def pack(bucket, tensor_of_key, dtype=None, lead=(), out=None):
    """The bucket's tensors (each ``[*lead, *entry.shape]``, None for
    zeros) raveled into one flat ``[*lead, bucket.numel]`` tensor of
    ``dtype`` (default the bucket's), zero-padded; written into ``out``
    when given (a buffer reused step after step)."""
    dt = dtype or bucket.dtype
    parts, dev = [], None
    for e in bucket.entries:
        t = tensor_of_key(e.key)
        if t is not None:
            dev = t.device
        parts.append(t)
    parts = [torch.zeros(lead + (e.numel,), dtype=dt, device=dev)
             if t is None else t.reshape(lead + (-1,)).to(dt)
             for e, t in zip(bucket.entries, parts)]
    pad = bucket.numel - sum(e.numel for e in bucket.entries)
    if pad:
        parts.append(torch.zeros(lead + (pad,), dtype=dt, device=dev))
    if out is not None:
        return out.copy_(parts[0]) if len(parts) == 1 else \
            torch.cat(parts, -1, out=out)
    return parts[0].clone() if len(parts) == 1 else torch.cat(parts, -1)


def unpack(flat, bucket):
    """``{entry.key: view}`` of a flat ``[*lead, bucket.numel]``."""
    lead = tuple(flat.shape[:-1])
    return {e.key: flat[..., e.offset:e.offset + e.numel]
            .reshape(lead + tuple(e.shape)) for e in bucket.entries}


def _reduce_dtype(dtype):
    """Low-precision buckets sum in fp32."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def shard_segments(bucket, rank, nranks):
    """The entries' pieces inside rank ``rank``'s shard of ``bucket``:
    ``[(entry, lo, hi)]`` with ``[lo, hi)`` in the entry's flat
    coordinates (the shard holds them at ``entry.offset + lo - start``)."""
    s = bucket.numel // nranks
    start, stop = rank * s, (rank + 1) * s
    out = []
    for e in bucket.entries:
        lo, hi = max(start, e.offset), min(stop, e.offset + e.numel)
        if lo < hi:
            out.append((e, lo - e.offset, hi - e.offset))
    return out


class GradBucketer:
    """The stage-2 / data-parallel grad planner over ``named_params``
    (trainable ``(key, Parameter)`` pairs in order): buckets padded to
    the group's degree."""

    def __init__(self, named_params, group=None, bucket_mb=None):
        self._params = dict(named_params)
        self.group = group or coll.get_group()
        bucket_bytes = None if bucket_mb is None else int(bucket_mb) * MB
        self.quant = _flags.get_flag("FLAGS_comm_quant") or ""
        n = self.group.nranks
        self.assignment = build_buckets(
            [(k, tuple(p.shape), p.dtype) for k, p in self._params.items()],
            bucket_bytes=bucket_bytes,
            pad_multiple=n * (coll.QUANT_BLOCK if self.quant else 1))
        self.shards = None          # this rank's grad shard a bucket
        self._bufs = {}             # reused step after step (`_buffer`)

    @property
    def num_buckets(self):
        return len(self.assignment.buckets)

    def _buffer(self, key, numel, dtype):
        """A buffer of at least ``numel`` elements, made once and reused
        (the collectives are synchronous: a bucket's is done before the
        next bucket writes the buffer)."""
        buf = self._bufs.get(key)
        if buf is None or buf.numel() < numel:
            dev = next(iter(self._params.values())).device
            buf = self._bufs[key] = torch.empty(numel, dtype=dtype,
                                                device=dev)
        return buf[:numel]

    def _flat(self, bucket):
        params = self._params
        dt = _reduce_dtype(bucket.dtype)
        return pack(bucket, lambda k: params[k].grad, dtype=dt,
                    out=self._buffer(("pack", dt), bucket.numel, dt))

    def reduce_scatter(self, average=True, release=False):
        """One reduce-scatter a bucket of the parameters' grads: this
        rank's shard of each bucket (its sum, divided by the degree with
        ``average``), in the bucket's dtype, kept in ``.shards`` (a
        tensor a bucket, the same ones every step) and returned. With
        ``release`` every grad is dropped after its bucket is packed: no
        full grad survives."""
        g, n = self.group, self.group.nranks
        shards = []
        for b in self.assignment.buckets:
            flat = self._flat(b)
            if release:
                for k in b.keys:
                    self._params[k].grad = None
            rd, s = flat.dtype, b.numel // n
            shard = self._buffer(("shard", b.index), s, b.dtype)
            red = shard if rd == b.dtype else \
                self._buffer(("reduce", rd), s, rd)
            if self.quant:
                red.copy_(coll.quantized_reduce_scatter(flat, g, self.quant))
            else:
                coll.reduce_scatter_into(red, flat, g)
            if average and n > 1:
                red.mul_(1.0 / n)
            if red is not shard:
                shard.copy_(red)
            shards.append(shard)
        self.shards = shards
        return shards

    def all_reduce(self, average=True):
        """One all-reduce a bucket; each grad gets its slice of the sum
        (the mean with ``average``) back, in its own dtype."""
        g, n = self.group, self.group.nranks
        for b in self.assignment.buckets:
            if all(self._params[k].grad is None for k in b.keys):
                continue
            flat = self._flat(b)
            coll.all_reduce_quantized(flat, group=g, qformat=self.quant)
            if average and n > 1:
                flat.mul_(1.0 / n)
            for k, v in unpack(flat, b).items():
                p = self._params[k]
                if p.grad is not None:        # an unused parameter stays
                    p.grad.copy_(v)           # without a grad


def bucketed_all_reduce(tensors, group=None, bucket_mb=None, quant=None):
    """Sum ``tensors`` over the group in place with one all-reduce a
    flat bucket (``bucket_mb`` cap; ``quant`` defaults to
    ``FLAGS_comm_quant``). Returns ``tensors``."""
    ts = list(tensors)
    if not ts:
        return tensors
    group = group or coll.get_group()
    if quant is None:
        quant = _flags.get_flag("FLAGS_comm_quant") or ""
    assignment = build_buckets(
        [(i, tuple(t.shape), t.dtype) for i, t in enumerate(ts)],
        bucket_bytes=None if bucket_mb is None else int(bucket_mb) * MB)
    for b in assignment.buckets:
        flat = pack(b, lambda i: ts[i], dtype=_reduce_dtype(b.dtype))
        coll.all_reduce_quantized(flat, group=group, qformat=quant)
        for i, v in unpack(flat, b).items():
            ts[i].copy_(v)
    return tensors


def bucketed_reduce_scatter(tensors, group=None, bucket_mb=None):
    """One reduce-scatter a flat bucket of ``tensors`` (padded to the
    group's degree): ``(assignment, shards)``, ``shards[b]`` this rank's
    block of bucket ``b``'s sum, the reference's result on block r of
    the bucket."""
    ts = list(tensors)
    group = group or coll.get_group()
    assignment = build_buckets(
        [(i, tuple(t.shape), t.dtype) for i, t in enumerate(ts)],
        bucket_bytes=None if bucket_mb is None else int(bucket_mb) * MB,
        pad_multiple=group.nranks)
    shards = [coll.reduce_scatter(pack(b, lambda i: ts[i]), group=group)
              for b in assignment.buckets]
    return assignment, shards
