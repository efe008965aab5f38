"""Collectives over ``torch.distributed``: the port of paddle_tpu/
distributed/collective.py (:36-942), and the comm stack's int8
quantizer, which the int8 paged KV pools store in too.

A `Group` wraps a ``torch.distributed`` process group: its ``ranks``
(global ranks, in group-rank order), ``nranks``, this process's
``rank`` in it (-1 outside) and `get_group_rank`. `new_group(axes=)`
builds one group for every line of the mesh along ``axes``, on every
rank in the same order (``torch.distributed.new_group`` is collective: a
rank that skips one hangs the rest) and returns this rank's. A group of
the whole world rides the default process group.

A collective takes the rank's local tensor. The reference's collectives
run on a global array sharded on dim 0 over the group; its results are
the contract here: on rank r's block each collective gives what the
reference's gives for block r (``all_reduce`` in place; ``reduce_scatter``
returns the rank's block of the sum; ``all_gather`` stacks the ranks'
tensors on a new dim 0, ``all_gather_concat`` concatenates them; peers
and roots are group ranks). ``ReduceOp.AVG`` is a sum then a divide on
backends without AVG (gloo). ``p2p_permute`` is the pipeline ring's
permutation (the reference's ``ppermute``): group rank ``dst`` of each
``(src, dst)`` pair gets ``src``'s tensor, a rank that no pair feeds
gets zeros; `p2p_exchange` posts one rank's sends and receives of a
tick together (``batch_isend_irecv``), so a ring of them cannot
deadlock.

`all_reduce_quantized` carries the reference's compressed wire format
(`_quantized_sum`, reference :323-392): the fp32 flat tensor padded to
``n * 32``, the scatter leg an ``all_to_all`` of int8 payloads with one
fp32 scale a 32-element block (or bf16 payloads), an fp32 sum, the
reduced chunk requantized and ``all_gather``-ed. It is opt-in under
``FLAGS_comm_quant``.

Every collective call counts itself in ``calls`` (by kind) and its
payload bytes in ``payload_bytes``, as a kernel wrapper counts its
launches; ``calls_by_group`` counts them by kind and group (``kind@axes``,
``@world`` for the default group without axes).

gloo on the card (``init_parallel_env(backend="gloo", device="cuda")``:
ranks sharing one card, a harness for correctness, not a speed path):
gloo moves CUDA tensors through the host, and takes on CUDA tensors
only part of what it takes on the CPU (all-reduce and broadcast; no
reduce-scatter, no all-to-all, no bf16 everywhere). So a collective over
a gloo group copies its CUDA tensors to the host, runs there and copies
the result back, the same operation on the same bytes, for every kind
and dtype alike; each such call also counts in ``host_staged`` (by kind).
Nothing falls back silently: NCCL groups never take this path.
"""
from __future__ import annotations

import contextlib
import warnings
from collections import Counter

import torch
import torch.distributed as dist

from . import env

__all__ = ["Group", "P2POp", "ReduceOp", "all_gather", "all_gather_concat",
           "all_gather_into", "reduce_scatter_into",
           "all_gather_object", "all_reduce", "all_reduce_quantized",
           "alltoall", "alltoall_single", "barrier", "batch_isend_irecv",
           "broadcast", "broadcast_object_list", "dequantize_q8",
           "destroy_process_group", "get_group", "get_rank",
           "get_world_size", "irecv", "is_initialized", "isend",
           "new_group", "p2p_exchange", "p2p_permute",
           "quantize_symmetric_q8", "recv",
           "reduce", "reduce_scatter", "scatter", "send", "calls",
           "payload_bytes", "reset_counts"]

QUANT_BLOCK = 32           # int8 scaling block, both legs (reference :342)

calls = Counter()          # collective kind -> calls
payload_bytes = Counter()  # collective kind -> bytes this rank sent in
calls_by_group = Counter()  # "kind@axes" -> calls
host_staged = Counter()    # collective kind -> calls over the host (gloo)


def reset_counts():
    calls.clear()
    payload_bytes.clear()
    calls_by_group.clear()
    host_staged.clear()


def _label(g):
    if g is None:
        return "world"
    if g.axes:
        return "+".join(g.axes)
    return "world" if g.pg is None else "ranks"


def _count(kind, *tensors, group=None):
    calls[kind] += 1
    calls_by_group[f"{kind}@{_label(group)}"] += 1
    payload_bytes[kind] += sum(t.numel() * t.element_size()
                               for t in tensors)


# ---------------------------------------------------------------------------
# the int8 quantizer (wire and storage format)
# ---------------------------------------------------------------------------

def _symmetric(x, axis, qmax):
    """(round(x / scale) clipped to [-qmax, qmax] as fp32, scales fp32
    with ``axis`` removed). The divisor is a full tensor, not a Python
    number: PyTorch's CUDA division by a scalar multiplies by its
    reciprocal, which can differ from the reference's division by one
    unit in the last place. ``max|x|`` is the inf-norm: one kernel, and
    exact."""
    xf = x.float()
    amax = torch.linalg.vector_norm(xf, float("inf"), dim=axis) \
        .clamp_min(1e-30)
    sc = amax / torch.full_like(amax, qmax)
    q = torch.round(xf / sc.unsqueeze(axis)).clamp_(-qmax, qmax)
    return q, sc


def quantize_symmetric_q8(x, axis=-1):
    """(q int8, scales fp32 with ``axis`` removed): one scale per
    ``axis``-row, ``max|x|`` floored at 1e-30 over 127, the payload
    ``round(x / scale)`` (half to even) clipped to [-127, 127]."""
    q, sc = _symmetric(x, axis, 127.0)
    return q.to(torch.int8), sc


def dequantize_q8(q, scales, axis=-1, dtype=torch.float32):
    """Inverse of `quantize_symmetric_q8`: ``q * scale`` broadcast along
    ``axis``."""
    return (q.float() * scales.unsqueeze(axis)).to(dtype)


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


class Group:
    """A communication group (reference communication/group.py): the
    global ``ranks`` in group-rank order over the process group ``pg``
    (None: the default group of the whole world)."""

    _next_id = 0

    def __init__(self, ranks, pg=None, axes=None, name=None):
        self.ranks = list(ranks)
        self.pg = pg
        self.axes = None if axes is None else tuple(axes)
        Group._next_id += 1
        self.id = Group._next_id
        self.name = name or f"group_{self.id}"

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's rank in the group (-1 outside it)."""
        return self.get_group_rank(env.get_rank())

    @property
    def process_ids(self):
        return list(self.ranks)

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def global_rank(self, group_rank):
        return self.ranks[group_rank]

    def __repr__(self):
        return f"Group(ranks={self.ranks}, axes={self.axes})"


_world = None


def _world_group() -> Group:
    global _world
    env._require()
    if _world is None:
        _world = Group(range(env.get_world_size()), None, name="world")
    return _world


def _reset():
    global _world
    _world = None


def get_group(gid=None) -> Group:
    return _world_group()


def _make(ranks, axes=None, backend=None, timeout=None):
    """One group over ``ranks``; every rank calls this for every group."""
    ranks = list(map(int, ranks))
    if ranks == list(range(env.get_world_size())) and backend is None:
        return Group(ranks, None, axes)
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    return Group(ranks, pg, axes)


def new_group(ranks=None, backend=None, timeout=None, axes=None,
              mesh=None) -> Group:
    """Reference collective.py:151. With ``axes``: a group for every line
    of ``mesh`` (default: the world's) along those axes, all built here
    on every rank, this rank's returned (cached on the mesh). With
    ``ranks``: one group; every rank of the world must call it."""
    env._require()
    if axes is not None:
        mesh = mesh or env.get_mesh()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in mesh._groups:
            me, mine = env.get_rank(), None
            for line in mesh.comm_lists(axes):
                g = _make(line, axes, backend, timeout)
                if me in line:
                    mine = g
            mesh._groups[axes] = mine
        return mesh._groups[axes]
    if ranks is None:
        return _world_group()
    return _make(sorted(ranks), None, backend, timeout)


def _g(group):
    return group or _world_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _backend(g):
    return env.get_backend() if g.pg is None else dist.get_backend(g.pg)


def _avg_native(g):
    return _backend(g) == "nccl"


def _staged(g, kind, *tensors):
    """True when ``g`` is a gloo group and a tensor is on the card: the
    call then runs on host copies (module docstring)."""
    if any(t is not None and t.is_cuda for t in tensors) \
            and _backend(g) == "gloo":
        host_staged[kind] += 1
        return True
    return False


def _host(t):
    return None if t is None else t.detach().cpu()


def _back(dst, src):
    """``src`` (a host copy) written into ``dst``, which it stands for."""
    if src is not dst:
        dst.copy_(src)
    return dst


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place on ``tensor`` (reference communication/all_reduce.py):
    SUM, MAX, MIN, PROD or AVG over the group."""
    g = _g(group)
    _count("all_reduce", tensor, group=g)
    x = _host(tensor) if _staged(g, "all_reduce", tensor) else tensor
    if op == ReduceOp.AVG:
        if _avg_native(g):
            dist.all_reduce(x, dist.ReduceOp.AVG, group=g.pg)
        else:
            dist.all_reduce(x, dist.ReduceOp.SUM, group=g.pg)
            x.div_(g.nranks)
        return _back(tensor, x)
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    dist.all_reduce(x, _TORCH_OPS[op], group=g.pg)
    return _back(tensor, x)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands on group rank ``dst`` (in place there)."""
    g = _g(group)
    _count("reduce", tensor, group=g)
    x = _host(tensor) if _staged(g, "reduce", tensor) else tensor
    if op == ReduceOp.AVG:
        dist.reduce(x, g.global_rank(dst), dist.ReduceOp.SUM, group=g.pg)
        if g.rank == dst:
            x.div_(g.nranks)
        return _back(tensor, x)
    dist.reduce(x, g.global_rank(dst), _TORCH_OPS[op], group=g.pg)
    return _back(tensor, x)


def _gather_flat(out, x, g):
    """``all_gather_into_tensor`` (``out`` [n * numel] of ``x``)."""
    if _staged(g, "all_gather", out, x):
        return _back(out, _gather_flat(_host(out), _host(x), g))
    with warnings.catch_warnings():
        # torch 2.13 marks it deprecated; torch 2.11 has no successor
        warnings.simplefilter("ignore", FutureWarning)
        warnings.simplefilter("ignore", DeprecationWarning)
        dist.all_gather_into_tensor(out, x, group=g.pg)
    return out


def _scatter_flat(out, x, op, g):
    if _staged(g, "reduce_scatter", out, x):
        return _back(out, _scatter_flat(_host(out), _host(x), op, g))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        warnings.simplefilter("ignore", DeprecationWarning)
        dist.reduce_scatter_tensor(out, x, op, group=g.pg)
    return out


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """The ranks' tensors stacked on a new dim 0 (reference
    communication/all_gather.py); filled into ``tensor_list`` when given.
    For a concatenation along an existing dim use `all_gather_concat`."""
    if axis != 0:
        raise NotImplementedError(
            "all_gather stacks on a new leading dim; for a concat along an "
            "existing axis use all_gather_concat(tensor, axis=...)")
    g = _g(group)
    x = tensor.contiguous()
    out = torch.empty((g.nranks,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    _count("all_gather", x, group=g)
    _gather_flat(out.view(-1), x.view(-1), g)
    if tensor_list is not None:
        del tensor_list[:]
        tensor_list.extend(out.unbind(0))
        return tensor_list
    return out


def all_gather_into(out, shard, group=None):
    """The ranks' flat ``shard`` s gathered into the flat ``out`` (rank
    order), in place: ``shard`` may be ``out``'s own slice of this rank,
    as NCCL and gloo both allow."""
    g = _g(group)
    _count("all_gather", shard, group=g)
    return _gather_flat(out.view(-1), shard.reshape(-1), g)


def all_gather_concat(tensor, group=None, axis=0):
    """The ranks' tensors concatenated along ``axis`` (a tiled gather)."""
    stacked = all_gather(None, tensor, group)
    return torch.cat(stacked.unbind(0), dim=axis)


def reduce_scatter(tensor, tensor_or_tensor_list=None, op=ReduceOp.SUM,
                   group=None, sync_op=True, axis=0):
    """Sum over the group, then rank r keeps block r along ``axis``
    (reference communication/reduce_scatter.py). Forms: ``(out,
    [n inputs])``; ``(out, input)``; ``(input)`` or ``(None, input)``,
    which return a new block."""
    g = _g(group)
    src = tensor_or_tensor_list if tensor_or_tensor_list is not None \
        else tensor
    out = tensor if tensor_or_tensor_list is not None else None
    if isinstance(src, (list, tuple)):
        src = torch.stack(list(src)) if axis == 0 else torch.cat(src, axis)
        if axis == 0:
            src = src.reshape((-1,) + tuple(src.shape[2:]))
    n = g.nranks
    if src.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of size "
                         f"{src.shape[axis]} does not split over {n} ranks")
    moved = src.movedim(axis, 0).contiguous()
    block = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                        dtype=src.dtype, device=src.device)
    _count("reduce_scatter", moved, group=g)
    if op == ReduceOp.AVG and not _avg_native(g):
        _scatter_flat(block.view(-1), moved.view(-1), dist.ReduceOp.SUM, g)
        block.div_(n)
    else:
        top = dist.ReduceOp.AVG if op == ReduceOp.AVG else _TORCH_OPS[op]
        _scatter_flat(block.view(-1), moved.view(-1), top, g)
    block = block.movedim(0, axis)
    if out is not None:
        out.copy_(block)
        return out
    return block


def reduce_scatter_into(out, flat, group=None):
    """The sum over the group of the flat ``flat`` [n * c], this rank's
    block written into ``out`` [c] (no other allocation)."""
    g = _g(group)
    _count("reduce_scatter", flat, group=g)
    return _scatter_flat(out.view(-1), flat.reshape(-1), dist.ReduceOp.SUM,
                         g)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank gets group rank ``src``'s value, in place."""
    g = _g(group)
    _count("broadcast", tensor, group=g)
    x = _host(tensor) if _staged(g, "broadcast", tensor) else tensor
    dist.broadcast(x, g.global_rank(src), group=g.pg)
    return _back(tensor, x)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Group rank ``src``'s ``tensor_list[i]`` lands in rank i's
    ``tensor``, in place."""
    g = _g(group)
    parts = None
    if g.rank == src:
        parts = [t.to(tensor.dtype).contiguous() for t in tensor_list]
        _count("scatter", *parts, group=g)
    else:
        _count("scatter", group=g)
    x = tensor
    if _staged(g, "scatter", tensor):
        x = _host(tensor)
        parts = None if parts is None else [_host(t) for t in parts]
    dist.scatter(x, parts, g.global_rank(src), group=g.pg)
    return _back(tensor, x)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Block i of ``in_tensor`` (dim 0, equal or given splits) goes to
    rank i; ``out_tensor`` gets block r of every rank, in rank order."""
    g = _g(group)
    x = in_tensor.contiguous()
    if out_tensor is None:
        if out_split_sizes:
            shape = (sum(out_split_sizes),) + tuple(x.shape[1:])
        else:
            shape = tuple(x.shape)
        out_tensor = torch.empty(shape, dtype=x.dtype, device=x.device)
    _count("alltoall", x, group=g)
    out = out_tensor
    if _staged(g, "alltoall", x):
        out, x = _host(out_tensor), _host(x)
    dist.all_to_all_single(out, x,
                           output_split_sizes=out_split_sizes or None,
                           input_split_sizes=in_split_sizes or None,
                           group=g.pg)
    return _back(out_tensor, out)


def alltoall(out_tensor_list, in_tensor_list=None, group=None, sync_op=True):
    """Reference communication/all_to_all.py: ``in_tensor_list[i]`` goes
    to rank i; ``out_tensor_list[j]`` is what rank j sent here. One
    ``all_to_all_single`` of the stacked list (gloo has no list form)."""
    if in_tensor_list is None:
        in_tensor_list = out_tensor_list
    stacked = torch.stack(list(in_tensor_list))
    out = alltoall_single(None, stacked, group=group)
    if out_tensor_list is not None:
        del out_tensor_list[:]
        out_tensor_list.extend(out.unbind(0))
        return out_tensor_list
    return out


def send(tensor, dst=0, group=None, sync_op=True):
    g = _g(group)
    _count("send", tensor)
    if sync_op:
        dist.send(tensor.contiguous(), g.global_rank(dst), group=g.pg)
        return None
    return dist.isend(tensor.contiguous(), g.global_rank(dst), group=g.pg)


def recv(tensor, src=0, group=None, sync_op=True):
    g = _g(group)
    _count("recv")
    if sync_op:
        dist.recv(tensor, g.global_rank(src), group=g.pg)
        return None
    return dist.irecv(tensor, g.global_rank(src), group=g.pg)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """A batched p2p descriptor (reference batch_isend_irecv.py:34)."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv, send, recv):
            raise ValueError("op must be paddle.distributed.isend or irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Run a batch of `P2POp` together (reference batch_isend_irecv.py:
    132); returns the tasks to ``wait()`` on."""
    if not p2p_op_list:
        raise ValueError("p2p_op_list must not be empty")
    ops = []
    for p in p2p_op_list:
        if not isinstance(p, P2POp):
            raise TypeError("batch_isend_irecv takes a list of P2POp")
        g = _g(p.group)
        send_op = p.op in (send, isend)
        _count("send" if send_op else "recv",
               *([p.tensor] if send_op else []))
        ops.append(dist.P2POp(dist.isend if send_op else dist.irecv,
                              p.tensor, g.global_rank(p.peer), group=g.pg))
    return dist.batch_isend_irecv(ops)


def p2p_exchange(sends=(), recvs=(), group=None):
    """One rank's part of a round of point-to-point transfers: ``sends``
    ``[(tensor, dst)]`` and ``recvs`` ``[(buffer, src)]`` (group ranks),
    posted together and waited for; each buffer is written in place and
    the list of them returned. Every rank's sends must meet the receives
    their peers post in the same round, in the same order between a
    pair. A transfer to oneself is a copy. Over a gloo group, CUDA
    tensors travel through host copies (the module docstring)."""
    g = _g(group)
    me = g.rank
    sends = [(t.contiguous(), d) for t, d in sends]
    recvs = list(recvs)
    selfs = [t for t, d in sends if d == me]
    ops, back = [], []
    for t, d in sends:
        if d == me:
            continue
        _count("send", t, group=g)
        if _staged(g, "send", t):
            t = _host(t)
        ops.append(dist.P2POp(dist.isend, t, g.global_rank(d), group=g.pg))
    for buf, s in recvs:
        if s == me:
            buf.copy_(selfs.pop(0))
            continue
        _count("recv", group=g)
        dst = buf
        if _staged(g, "recv", buf):
            dst = torch.empty(buf.shape, dtype=buf.dtype)
            back.append((buf, dst))
        ops.append(dist.P2POp(dist.irecv, dst, g.global_rank(s),
                              group=g.pg))
    if ops:
        for task in dist.batch_isend_irecv(ops):
            task.wait()
    for buf, host in back:
        buf.copy_(host)
    return [b for b, _ in recvs]


def _permute(x, perm, g):
    me = g.rank
    sends = [(x, d) for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"rank {me} is the destination of {len(srcs)} "
                         "pairs; a permutation feeds each rank once")
    if not srcs:
        p2p_exchange(sends, (), g)
        return torch.zeros_like(x)
    return p2p_exchange(sends, [(torch.empty_like(x), srcs[0])], g)[0]


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, g):
        ctx.perm, ctx.g = perm, g
        return _permute(x.detach(), perm, g)

    @staticmethod
    def backward(ctx, dy):
        return _permute(dy.contiguous(), [(d, s) for s, d in ctx.perm],
                        ctx.g), None, None


def p2p_permute(tensor, perm, group=None):
    """Reference collective.py:877 (``jax.lax.ppermute``): ``perm`` a
    list of ``(src, dst)`` group ranks; this rank gets the tensor of the
    ``src`` that names it (zeros if none). Every rank of the group calls
    it with the same ``perm``. Differentiable: the backward is the
    reverse permutation, as JAX differentiates ``ppermute``."""
    g = _g(group)
    perm = [(int(s), int(d)) for s, d in perm]
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _Permute.apply(tensor, perm, g)
    return _permute(tensor, perm, g)


def barrier(group=None):
    g = _g(group)
    _count("barrier")
    if _backend(g) == "nccl":
        dist.barrier(group=g.pg, device_ids=[env.get_device().index])
    else:
        dist.barrier(group=g.pg)


def all_gather_object(object_list, obj, group=None):
    g = _g(group)
    out = [None] * g.nranks
    _count("all_gather_object")
    dist.all_gather_object(out, obj, group=g.pg)
    del object_list[:]
    object_list.extend(out)
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    g = _g(group)
    _count("broadcast_object_list")
    dist.broadcast_object_list(object_list, g.global_rank(src), group=g.pg)
    return object_list


def get_world_size(group=None) -> int:
    return group.nranks if group is not None else env.get_world_size()


def get_rank(group=None) -> int:
    return group.rank if group is not None else env.get_rank()


def is_initialized() -> bool:
    return env.is_initialized()


def destroy_process_group(group=None):
    """Destroy ``group``'s process group, or with none the whole world
    (`env.reset`)."""
    if group is None:
        env.reset()
    elif group.pg is not None:
        dist.destroy_process_group(group.pg)


# ---------------------------------------------------------------------------
# the compressed all-reduce
# ---------------------------------------------------------------------------

def quantized_sum(x, group=None, qformat="int8"):
    """The reference's compressed sum of ``x`` over the group, as a new
    tensor of ``x``'s shape and dtype (see the module docstring)."""
    if qformat not in ("int8", "bf16"):
        raise ValueError(
            f"unsupported comm quant format {qformat!r} (int8|bf16)")
    g = _g(group)
    n, b = g.nranks, QUANT_BLOCK
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % (n * b)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.view(n, -1)
    c = chunks.shape[1]
    if qformat == "int8":
        q, s1 = quantize_symmetric_q8(chunks.view(n, c // b, b))
        recv_q = alltoall_single(None, q, group=g)
        recv_s = alltoall_single(None, s1, group=g)
        red = (recv_q.float() * recv_s[..., None]).sum(0)        # [c/b, b]
        q2, s2 = quantize_symmetric_q8(red)
        gq = all_gather(None, q2, group=g)                   # [n, c/b, b]
        gs = all_gather(None, s2, group=g)                   # [n, c/b]
        out = (gq.float() * gs[..., None]).reshape(-1)
    else:
        recv_h = alltoall_single(None, chunks.to(torch.bfloat16), group=g)
        red = recv_h.float().sum(0)
        out = all_gather(None, red.to(torch.bfloat16),
                         group=g).float().reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


def quantized_sum_plain(xs, qformat="int8"):
    """The plain version of `quantized_sum`: the recipe over the ranks'
    tensors ``xs`` (a list, one a rank) in one process, no collective;
    the result every rank gets. The same operations in the same order,
    so on one device it is bit for bit the collective's."""
    n, b = len(xs), QUANT_BLOCK
    chunks = []
    for x in xs:
        flat = x.float().reshape(-1)
        pad = (-flat.numel()) % (n * b)
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        chunks.append(flat.view(n, -1))
    c = chunks[0].shape[1]
    if qformat == "int8":
        sent = [quantize_symmetric_q8(ch.view(n, c // b, b))
                for ch in chunks]
        parts = []
        for r in range(n):
            rq = torch.stack([q[r] for q, _ in sent])
            rs = torch.stack([sc[r] for _, sc in sent])
            parts.append(quantize_symmetric_q8(
                (rq.float() * rs[..., None]).sum(0)))
        gq = torch.stack([q for q, _ in parts])
        gs = torch.stack([sc for _, sc in parts])
        out = (gq.float() * gs[..., None]).reshape(-1)
    elif qformat == "bf16":
        out = torch.stack([
            torch.stack([ch[r].to(torch.bfloat16) for ch in chunks])
            .float().sum(0).to(torch.bfloat16)
            for r in range(n)]).float().reshape(-1)
    else:
        raise ValueError(
            f"unsupported comm quant format {qformat!r} (int8|bf16)")
    x = xs[0]
    return out[:x.numel()].reshape(x.shape).to(x.dtype)


def all_reduce_quantized(tensor, op=ReduceOp.SUM, group=None, qformat=None,
                         sync_op=True):
    """Compressed ``all_reduce`` (SUM only), in place. ``qformat``
    defaults to ``FLAGS_comm_quant``; with it unset ('') this is
    `all_reduce`: the compressed path is opt-in."""
    if qformat is None:
        from ..utils import flags

        qformat = flags.get_flag("FLAGS_comm_quant") or ""
    if not qformat:
        return all_reduce(tensor, op=op, group=group)
    if op not in (ReduceOp.SUM, "sum"):
        raise ValueError(
            f"quantized collectives support ReduceOp.SUM only, got {op}")
    tensor.copy_(quantized_sum(tensor, group, qformat))
    return tensor


def quantized_reduce_scatter(flat, group=None, qformat="int8"):
    """The scatter leg alone (reference quantized_psum_scatter_traced):
    ``flat`` [n * c] (c whole 32-blocks for int8) -> this rank's [c]
    chunk of the sum, accumulated in fp32."""
    g = _g(group)
    n, b = g.nranks, QUANT_BLOCK
    chunks = flat.float().view(n, -1)
    c = chunks.shape[1]
    if qformat == "int8":
        if c % b:
            raise ValueError(f"chunk {c} not a multiple of the {b}-wide "
                             "int8 scaling block")
        q, sc = quantize_symmetric_q8(chunks.view(n, c // b, b))
        rq = alltoall_single(None, q, group=g)
        rs = alltoall_single(None, sc, group=g)
        return (rq.float() * rs[..., None]).sum(0).reshape(-1).to(flat.dtype)
    rh = alltoall_single(None, chunks.to(torch.bfloat16), group=g)
    return rh.float().sum(0).to(flat.dtype)


def quantized_all_gather(shard, group=None, qformat="int8"):
    """The gather leg alone (reference quantized_all_gather_traced): each
    rank's flat ``shard`` [c] quantized once, gathered with its scales,
    dequantized: [n * c]."""
    g = _g(group)
    b = QUANT_BLOCK
    c = shard.numel()
    if qformat == "int8":
        if c % b:
            raise ValueError(f"gather dim {c} not a multiple of the {b}-"
                             "wide int8 scaling block")
        q, sc = quantize_symmetric_q8(shard.float().view(c // b, b))
        gq = all_gather(None, q, group=g)
        gs = all_gather(None, sc, group=g)
        return (gq.float() * gs[..., None]).reshape(-1).to(shard.dtype)
    return all_gather(None, shard.to(torch.bfloat16),
                      group=g).reshape(-1).to(shard.dtype)


@contextlib.contextmanager
def counting():
    """Counts of the collectives run inside the block: yields a dict
    filled on exit ({kind: calls}, plus "bytes", "by_group" ({"kind@axes":
    calls}) and, where calls went over the host, "host_staged")."""
    before_c, before_b = Counter(calls), Counter(payload_bytes)
    before_g, before_h = Counter(calls_by_group), Counter(host_staged)
    got = {}

    def grown(now, before):
        return {k: n - before.get(k, 0) for k, n in now.items()
                if n - before.get(k, 0)}

    try:
        yield got
    finally:
        got.update(grown(calls, before_c))
        got["bytes"] = sum(payload_bytes.values()) - sum(before_b.values())
        got["by_group"] = grown(calls_by_group, before_g)
        staged = grown(host_staged, before_h)
        if staged:
            got["host_staged"] = staged

