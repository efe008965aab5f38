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
gives this rank's shard of each bucket's sum.

Stage 3 (`sharding.GroupShardedStage3`) holds a bucket's flat parameter
buffer as the rank's shard alone (`FlatShard`): `release` frees the
whole buffer's storage (the parameters, views into it, keep their
shapes and hold no memory), `gather` all-gathers the shards back into
the same storage, so the views, and whatever autograd saved of them,
read the whole values again. The reference's
``count_hlo_collectives`` counts collectives in compiled HLO; here
`collective.calls` counts the calls themselves.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import flags as _flags
from . import collective as coll

__all__ = ["MB", "Bucket", "BucketAssignment", "BucketEntry", "FlatShard",
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


def build_buckets(named_shapes, bucket_bytes=None, pad_multiple=1,
                  tags=None):
    """Greedy packing of ``(key, shape, dtype)`` in the given order: a
    new bucket when the dtype changes or the cap would be passed (a
    single oversized tensor still gets its own; a cap of 0 gives one
    tensor a bucket), each bucket padded up to ``pad_multiple``. The
    reference's assignment, entry for entry. ``tags`` (one a tensor): a
    new bucket also where the tag changes."""
    if bucket_bytes is None:
        bucket_bytes = default_bucket_bytes()
    bucket_bytes = max(int(bucket_bytes), 1)
    pad_multiple = max(int(pad_multiple), 1)
    buckets = []
    cur, cur_dtype, cur_numel, cur_tag = [], None, 0, None

    def close():
        nonlocal cur, cur_dtype, cur_numel
        if not cur:
            return
        padded = -(-cur_numel // pad_multiple) * pad_multiple
        buckets.append(Bucket(len(buckets), cur_dtype, tuple(cur), padded))
        cur, cur_dtype, cur_numel = [], None, 0

    for i, (key, shape, dtype) in enumerate(named_shapes):
        dtype = _dtype(dtype)
        numel = int(np.prod(shape)) if len(shape) else 1
        nbytes = numel * _itemsize(dtype)
        tag = None if tags is None else tags[i]
        if cur and (dtype != cur_dtype or tag != cur_tag or
                    cur_numel * _itemsize(cur_dtype) + nbytes
                    > bucket_bytes):
            close()
        cur_dtype, cur_tag = dtype, tag
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
    the group's degree (``tags``: `build_buckets`')."""

    def __init__(self, named_params, group=None, bucket_mb=None, tags=None):
        self._params = dict(named_params)
        self.group = group or coll.get_group()
        bucket_bytes = None if bucket_mb is None else int(bucket_mb) * MB
        self.quant = _flags.get_flag("FLAGS_comm_quant") or ""
        n = self.group.nranks
        self.assignment = build_buckets(
            [(k, tuple(p.shape), p.dtype) for k, p in self._params.items()],
            bucket_bytes=bucket_bytes,
            pad_multiple=n * (coll.QUANT_BLOCK if self.quant else 1),
            tags=tags)
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

    def reduce_scatter(self, average=True, release=False, buckets=None,
                       accumulate=False):
        """One reduce-scatter a bucket of the parameters' grads: this
        rank's shard of each bucket (its sum, divided by the degree with
        ``average``), in the bucket's dtype, kept in ``.shards`` (a
        tensor a bucket, the same ones every step) and returned. With
        ``release`` every grad is dropped after its bucket is packed: no
        full grad survives. ``buckets``: those alone (default all);
        ``accumulate``: added to a bucket's shard already in ``.shards``
        (stage 3 scatters each micro-batch's grads as they complete)."""
        g, n = self.group, self.group.nranks
        shards = (list(self.shards) if self.shards is not None
                  else [None] * self.num_buckets)
        for b in (self.assignment.buckets if buckets is None else buckets):
            flat = self._flat(b)
            if release:
                for k in b.keys:
                    self._params[k].grad = None
            rd, s = flat.dtype, b.numel // n
            shard = self._buffer(("shard", b.index), s, b.dtype)
            add = accumulate and shards[b.index] is not None
            red = shard if rd == b.dtype and not add else \
                self._buffer(("reduce", rd), s, rd)
            if self.quant:
                red.copy_(coll.quantized_reduce_scatter(flat, g, self.quant))
            else:
                coll.reduce_scatter_into(red, flat, g)
            if average and n > 1:
                red.mul_(1.0 / n)
            if add:
                shard.add_(red)
            elif red is not shard:
                shard.copy_(red)
            shards[b.index] = shard
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


class FlatShard:
    """One bucket's flat parameter buffer ``flat`` held as this rank's
    contiguous shard between uses (stage 3). ``shard`` keeps the rank's
    values (with ``offload`` on a card: in pinned host memory, copied
    to the card for the gather and the update); `release` frees the
    flat buffer's storage, `gather` all-gathers the shards back into it
    (the same storage object, so every view of it reads the whole
    values again). On the CPU ``offload`` changes nothing."""

    def __init__(self, flat, rank, group, offload=False):
        n = group.nranks
        s = flat.numel() // n
        self.flat, self.group, self.rank = flat, group, rank
        self.nbytes = flat.untyped_storage().nbytes()
        self.offload = bool(offload) and flat.device.type == "cuda"
        shard = flat[rank * s:(rank + 1) * s].clone()
        self.shard = shard.cpu().pin_memory() if self.offload else shard
        # what the update reads and writes on the card: the shard, or its
        # staging copy (`stage_in` / `stage_out`)
        self.device_values = shard if self.offload else self.shard
        self.gathered = True

    @property
    def device(self):
        return self.flat.device

    def values(self):
        """The rank's values on the flat's device (a copy when they are
        offloaded)."""
        return self.shard.to(self.device) if self.offload else self.shard

    @torch.no_grad()
    def gather(self):
        if self.gathered:
            return
        self.flat.untyped_storage().resize_(self.nbytes)
        coll.all_gather_into(self.flat, self.values(), self.group)
        self.gathered = True

    @torch.no_grad()
    def refresh(self):
        """After an update of the shard: the whole values again, where
        they are gathered."""
        if self.gathered:
            coll.all_gather_into(self.flat, self.values(), self.group)

    @torch.no_grad()
    def stage_in(self):
        """Offloaded: the shard copied to the card for the update."""
        if self.offload:
            v = self.device_values
            v.untyped_storage().resize_(v.numel() * v.element_size())
            v.copy_(self.shard)

    @torch.no_grad()
    def stage_out(self):
        """Offloaded: the updated shard back to host memory, the card's
        copy freed."""
        if self.offload:
            self.shard.copy_(self.device_values)
            self.device_values.untyped_storage().resize_(0)

    @torch.no_grad()
    def keep(self):
        """The rank's slice of the gathered buffer (new values written
        into it) back into the shard."""
        s = self.flat.numel() // self.group.nranks
        self.shard.copy_(self.flat[self.rank * s:(self.rank + 1) * s])

    def release(self):
        if self.gathered:
            self.flat.untyped_storage().resize_(0)
            self.gathered = False

    def resident_bytes(self):
        """This bucket's parameter bytes on this rank now: its shard and,
        where gathered, the whole buffer (the shard in host memory under
        ``offload`` counts 0 on the card)."""
        own = 0 if self.offload else self.shard.numel() \
            * self.shard.element_size()
        return own + self.flat.untyped_storage().nbytes()


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
