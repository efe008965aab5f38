"""The pipeline ring: the port of paddle_tpu/distributed/fleet/
meta_parallel/spmd_pipeline.py (:30-355).

The reference runs every stage in one program: a ``lax.scan`` of ring
ticks in which each stage applies its layers to the micro-batch it holds
and ``ppermute`` s the result to the next stage; stage 0 injects fresh
micro-batches and collects the finished ones (the ring wraps the last
stage back to it), and JAX differentiates the scan into the reverse
ring. Here a stage is a rank of a pipeline group, and the same schedule
runs tick by tick in each rank:

* `Ring.forward`: ``n_stages + n_micro - 1`` ticks; at tick ``t`` stage
  ``s`` runs micro-batch ``t - s`` (none in its bubble ticks), then one
  `collective.p2p_exchange` sends what it made to stage ``s + 1`` and
  receives what stage ``s - 1`` made (stage 0: the finished micro-batch
  of the last stage). The sends and receives pair exactly: a bubble tick
  moves nothing.
* `Ring.backward`: the reverse ring, the ticks in reverse: stage ``s``
  receives the cotangent of its micro-batch ``t - s`` from stage
  ``s + 1`` (the last stage from stage 0, which holds the collected
  outputs' cotangents), recomputes its stage with autograd from the
  input it kept and sends the input's cotangent to stage ``s - 1`` at
  the next tick. Each stage's parameter grads sum over its micro-batches:
  exactly the single-device grads, as the reference's bubble ticks add
  nothing.

`pipeline_spmd` (homogeneous stages, ``num_chunks`` virtual stages a
rank run as successive ring passes, the VPP round-robin placement:
chunk ``c`` of stage ``s`` is logical stage ``c * n_stages + s``) and
`pipeline_spmd_hetero` (stages of their own shapes and dtypes: the first
transfer on each edge carries a header with the shape and dtype, so a
receiver allocates what it gets; integer token ids cross as they are)
are autograd functions of the rank's own stage parameters: a rank holds
only its stage. The backward's recompute replays each application's
generator state, so dropout inside a stage draws the forward's masks. Their output is stage 0's collected outputs broadcast
to every rank of the group (the reference's result is replicated), and
their backward takes the cotangent of stage 0 alone and broadcasts the
input's grad back, so the grads carry no factor of the stage count.
Every rank of the group must call them, and call backward on what
depends on the output.

The zero-bubble ring (reference :358-633): `zb_linear_pipeline` (the
tanh-linear ring with its backward written by hand) and
`pipeline_spmd_zb` (any shape-keeping stage body) run the same forward,
and a backward whose ticks compute the input's cotangent alone: a tick
recomputes its stage from the kept input with the stage's leaves
detached (no weight-gradient node exists in it, as the reference's
leaves are a closure capture) and keeps its ``(x, dy)`` pair; after the
ring the weight grads fold over the rank's ``n_micro`` real
micro-batches, outside the ring's critical path: one contraction for the
tanh-linear ring, a recompute and a grad a micro-batch in chunks of
``dw_chunk`` for a general body, accumulated in fp32 and cast to the
parameter's dtype at the end. The sends and receives pair as
`Ring.backward` pairs them; only what a tick computes changes.
"""
from __future__ import annotations

import torch

from ... import collective as coll

__all__ = ["Ring", "microbatch", "pipeline_spmd", "pipeline_spmd_hetero",
           "pipeline_spmd_zb", "unmicrobatch", "zb_linear_pipeline"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool]
_HDR = 16


def _header(t, dev):
    h = torch.zeros(_HDR, dtype=torch.int64)
    h[0], h[1] = t.ndim, _DTYPES.index(t.dtype)
    h[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    return h.to(dev)


def _spec(h):
    h = h.cpu().tolist()
    return tuple(h[2:2 + h[0]]), _DTYPES[h[1]]


def _rng_state(dev):
    return (torch.cuda.get_rng_state(dev) if dev.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(dev, state):
    if dev.type == "cuda":
        torch.cuda.set_rng_state(state, dev)
    else:
        torch.set_rng_state(state)


def _floating(dtype):
    return dtype.is_floating_point or dtype.is_complex


class Ring:
    """One rank's place on a pipeline ring: the ``group`` (None or one
    rank: a ring of one stage, no transfer), its ``stage`` (group rank)
    and ``n`` stages. With ``headers``, the first transfer on each edge
    (a key the two ends name alike) sends the tensor's shape and dtype
    first."""

    def __init__(self, group=None, device=None, headers=False):
        self.group = group if group is not None and group.nranks > 1 \
            else None
        self.n = 1 if self.group is None else group.nranks
        self.stage = 0 if self.group is None else group.rank
        self.device = device
        self.headers = headers
        self._sent, self._specs = set(), {}

    def exchange(self, sends, recvs):
        """``sends`` ``[(tensor, dst stage, key)]``, ``recvs`` ``[(buffer
        or None, src stage, key)]`` (None: allocate from the edge's
        header): one round; returns the received tensors."""
        if self.headers:
            hs = [(_header(t, t.device), d) for t, d, k in sends
                  if k not in self._sent]
            hr = [(torch.empty(_HDR, dtype=torch.int64,
                               device=self.device), s)
                  for b, s, k in recvs if b is None and k not in self._specs]
            if hs or hr:
                got = coll.p2p_exchange(hs, hr, self.group)
                fresh = [k for b, s, k in recvs
                         if b is None and k not in self._specs]
                for k, h in zip(fresh, got):
                    self._specs[k] = _spec(h)
            self._sent.update(k for _, _, k in sends)
        bufs = []
        for b, s, k in recvs:
            if b is None:
                shape, dtype = self._specs[k]
                b = torch.empty(shape, dtype=dtype, device=self.device)
            bufs.append((b, s))
        if not sends and not bufs:
            return []
        return coll.p2p_exchange([(t, d) for t, d, _ in sends], bufs,
                                 self.group)

    # -- one pass of the ring -------------------------------------------
    def forward(self, apply, fresh, n_micro, like=None):
        """One ring pass without autograd: ``apply(m, x)`` is this stage
        on micro-batch ``m``'s input, ``fresh(m)`` stage 0's input of
        micro-batch ``m``, ``like(m)`` a buffer for what this stage
        receives (None: from the edge's header). Returns ``(outs, ins)``:
        on stage 0 the collected outputs of the last stage (None
        elsewhere), and this stage's inputs, one a micro-batch."""
        n, s, M = self.n, self.stage, n_micro
        ins, outs = [None] * M, [None] * M
        if n == 1:
            for m in range(M):
                ins[m] = fresh(m)
                outs[m] = apply(m, ins[m])
            return outs, ins
        like = like or (lambda m: None)
        pending = None
        for t in range(n + M - 1):
            m = t - s
            sends = []
            if 0 <= m < M:
                ins[m] = fresh(m) if s == 0 else pending
                sends = [(apply(m, ins[m]), (s + 1) % n, ("f", s))]
            mp = t - (n - 1) if s == 0 else t - (s - 1)
            recvs = ([(like(mp), (s - 1) % n, ("f", (s - 1) % n))]
                     if 0 <= mp < M else [])
            got = self.exchange(sends, recvs)
            if recvs:
                if s == 0:
                    outs[mp] = got[0]
                else:
                    pending = got[0]
        return outs, ins

    def backward(self, vjp, dys, n_micro, like=None, send_dx=True,
                 recv_dy=True):
        """The reverse of one pass: ``vjp(m, dy)`` is this stage's
        backward on micro-batch ``m`` (its input's cotangent, None for an
        input without one), ``dys`` on stage 0 the collected outputs'
        cotangents, ``like(m)`` a buffer for the cotangent this stage
        receives. ``recv_dy`` / ``send_dx``: whether this stage's output
        and input carry cotangents (False for integer ones). Returns, on
        stage 0, the cotangents of the injected inputs."""
        n, s, M = self.n, self.stage, n_micro
        dxs = [None] * M
        if n == 1:
            for m in reversed(range(M)):
                dxs[m] = vjp(m, dys[m])
            return dxs
        like = like or (lambda m: None)
        pending = None
        for t in reversed(range(n + M - 1)):
            sends = []
            if s == 0:
                mc = t - (n - 1)
                if 0 <= mc < M and dys[mc] is not None:
                    sends = [(dys[mc], n - 1, ("b", 0))]
            elif send_dx and 0 <= t - s + 1 < M:
                sends = [(pending, s - 1, ("b", s))]
            m = t - s
            recvs = ([(like(m), (s + 1) % n, ("b", (s + 1) % n))]
                     if 0 <= m < M and recv_dy else [])
            got = self.exchange(sends, recvs)
            if 0 <= m < M:
                dx = vjp(m, got[0] if recvs else None)
                if s == 0:
                    dxs[m] = dx
                else:
                    pending = dx
        return dxs


def microbatch(x, n_micro):
    """``[b, ...]`` -> ``[n_micro, b // n_micro, ...]``."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(x):
    """``[n_micro, mb, ...]`` -> ``[b, ...]``."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _flatten(tree):
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda ls: dict(zip(keys, ls))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return list(tree), lambda ls: kind(ls)
    raise TypeError(f"stage params: a tensor, list, tuple or dict, got "
                    f"{type(tree).__name__}")


def _broadcast0(t, ring, spec=None):
    """Stage 0's ``t`` on every rank of the ring (others pass None and
    the ``(shape, dtype)`` ``spec``, or None: a header first)."""
    if ring.group is None:
        return t
    if spec is None:
        h = (_header(t, t.device) if ring.stage == 0 else
             torch.empty(_HDR, dtype=torch.int64, device=ring.device))
        coll.broadcast(h, 0, ring.group)
        spec = _spec(h)
    if ring.stage != 0:
        t = torch.empty(spec[0], dtype=spec[1], device=ring.device)
    coll.broadcast(t, 0, ring.group)
    return t


class _Pipe(torch.autograd.Function):
    """The ring passes as one autograd node of the rank's leaves."""

    @staticmethod
    def forward(ctx, run, x_micro, anchor, *leaves):
        ctx.run = run
        with torch.no_grad():
            out = run.forward(x_micro, leaves)
        ctx.x_float = _floating(x_micro.dtype)
        return out

    @staticmethod
    def backward(ctx, dy):
        run = ctx.run
        dx, grads = run.backward(dy)
        return (None, dx if ctx.x_float else None, None, *grads)


def _apply(run, x_micro, leaves):
    """``run`` as an autograd node. Under grad mode a leaf that needs no
    grad rides along (the anchor), so every rank's output has a backward
    even where none of its own inputs needs a grad: the reverse ring runs
    on every rank."""
    anchor = torch.zeros((), device=x_micro.device,
                         requires_grad=torch.is_grad_enabled())
    return _Pipe.apply(run, x_micro, anchor, *leaves)


class _Runner:
    """The state one call of `pipeline_spmd` / `pipeline_spmd_hetero`
    keeps between its forward and its backward. ``hetero``: the stages'
    shapes and dtypes are their own (integer activations carry no
    cotangent)."""

    def __init__(self, ring, passes, n_micro, hetero=False):
        self.ring, self.passes, self.M = ring, passes, n_micro
        self.hetero = hetero
        self.ins = []

    def forward(self, x_micro, leaves):
        ring, M = self.ring, self.M
        self.leaves = leaves
        xs = list(x_micro.unbind(0)) if ring.stage == 0 else None
        self.x_spec = (tuple(x_micro.shape[1:]), x_micro.dtype)
        self.rng = {}
        for p, (fn, like) in enumerate(self.passes):
            def apply(m, x, p=p, fn=fn):
                # the generator's state, which the recompute replays
                self.rng[p, m] = _rng_state(ring.device)
                y = fn(leaves, x)
                self.in_dtype, self.out_dtype = x.dtype, y.dtype
                return y

            outs, ins = ring.forward(apply, lambda m: xs[m], M, like)
            self.ins.append(ins)
            xs = outs
        y = torch.stack(xs) if ring.stage == 0 else None
        return _broadcast0(y, ring, None if self.hetero else
                           ((M,) + self.x_spec[0], self.x_spec[1]))

    def backward(self, dy):
        ring, M = self.ring, self.M
        leaves = self.leaves
        grads = [None] * len(leaves)
        dys = list(dy.unbind(0)) if ring.stage == 0 else None
        for p in reversed(range(len(self.passes))):
            fn, like = self.passes[p]
            ins = self.ins[p]

            def vjp(m, d, fn=fn, ins=ins, p=p):
                x = ins[m]
                fx = _floating(x.dtype)
                x = x.detach().requires_grad_(fx)
                ls = [t.detach().requires_grad_(t.requires_grad)
                      for t in leaves]
                y = self.replay(p, m, fn, ls, x)
                want = ([x] if fx else []) + [t for t in ls
                                               if t.requires_grad]
                if d is None or not want or not y.requires_grad:
                    return torch.zeros_like(x) if fx else None
                got = list(torch.autograd.grad(y, want, d,
                                               allow_unused=True))
                dx = got.pop(0) if fx else None
                k = 0
                for i, t in enumerate(ls):
                    if t.requires_grad:
                        g = got[k]
                        k += 1
                        if g is not None:
                            grads[i] = g if grads[i] is None \
                                else grads[i] + g
                return dx

            dys = ring.backward(
                vjp, dys, M, like,
                send_dx=not self.hetero or _floating(self.in_dtype),
                recv_dy=not self.hetero or _floating(self.out_dtype))
        self.ins = []
        return self.input_grad(dys), [
            torch.zeros_like(t) if g is None and t.requires_grad else g
            for t, g in zip(leaves, grads)]

    def replay(self, p, m, fn, ls, x):
        """``fn(ls, x)`` under grad mode, the generator in the state the
        forward of pass ``p`` on micro-batch ``m`` found it in."""
        dev = self.ring.device
        forked = [dev.index] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=forked), torch.enable_grad():
            _set_rng_state(dev, self.rng[p, m])
            return fn(ls, x)

    def input_grad(self, dys):
        """The injected inputs' cotangents ``dys`` (stage 0's) as the
        ``[n_micro, ...]`` grad of the input on every rank (None for an
        integer input)."""
        if not _floating(self.x_spec[1]):
            return None
        ring, M = self.ring, self.M
        dx = torch.stack([torch.zeros(self.x_spec[0], dtype=self.x_spec[1],
                                      device=ring.device)
                          if d is None else d for d in dys]) \
            if ring.stage == 0 else None
        return _broadcast0(dx, ring, ((M,) + self.x_spec[0],
                                      self.x_spec[1]))


def pipeline_spmd(block_fn, stage_params, x_micro, *, group=None,
                  num_chunks=1):
    """Run the rank's stage over the micro-batches on the ring (reference
    :60-116).

    Args:
      block_fn: ``(stage_params_slice, x_mb) -> y_mb``, one stage on one
        micro-batch; it keeps the activation's shape and dtype.
      stage_params: this rank's stage: a tensor or a list / tuple / dict
        of them, each with a leading ``[num_chunks]`` dim when
        ``num_chunks > 1`` (the reference's ``[n_stages, num_chunks, ...]``
        stack, the rank's ``[stage]``).
      x_micro: ``[n_micro, mb, ...]`` on every rank (stage 0's is read).
      group: the pipeline group (default: the fleet's pipe group, else
        the world).
      num_chunks: virtual stages a rank, run as successive ring passes.

    Returns ``[n_micro, mb, ...]``, the same on every rank."""
    group = _pipe_group(group)
    leaves, unflat = _flatten(stage_params)
    n_micro = int(x_micro.shape[0])
    ring = Ring(group, x_micro.device)
    like = (lambda m: torch.empty(tuple(x_micro.shape[1:]),
                                  dtype=x_micro.dtype,
                                  device=x_micro.device))

    def chunk_fn(c):
        if num_chunks == 1:
            return lambda ls, x: block_fn(unflat(list(ls)), x)
        return lambda ls, x: block_fn(unflat([t[c] for t in ls]), x)

    run = _Runner(ring, [(chunk_fn(c), like) for c in range(num_chunks)],
                  n_micro)
    return _apply(run, x_micro, leaves)


def pipeline_spmd_hetero(stage_fns, stage_params, x_micro, *, group=None,
                         out_shape=None, out_dtype=None):
    """`pipeline_spmd` without the shape-keeping contract (reference
    :186-355): ``stage_fns`` the ``n_stages`` functions ``(params, x) ->
    y`` (every rank passes them all; the rank runs its stage's),
    ``stage_params`` this rank's stage's parameters (it holds no other
    stage's), ``x_micro`` ``[n_micro, ...]`` stage 0's inputs (integer
    token ids too). A stage's input and output shapes and dtypes cross
    the ring once, as headers; integer activations cross as they are.
    ``out_shape`` / ``out_dtype`` (the last stage's micro-batch output)
    are checked when given. Returns ``[n_micro, ...]`` the last stage's
    outputs, the same on every rank."""
    group = _pipe_group(group)
    ring = Ring(group, x_micro.device, headers=True)
    if len(stage_fns) != ring.n:
        raise ValueError(f"need exactly {ring.n} stage_fns (the pipeline "
                         f"group has {ring.n} ranks)")
    leaves, unflat = _flatten(stage_params)
    fn = stage_fns[ring.stage]
    n_micro = int(x_micro.shape[0])

    run = _Runner(ring, [(lambda ls, x: fn(unflat(list(ls)), x), None)],
                  n_micro, hetero=True)
    out = _apply(run, x_micro, leaves)
    if out_shape is not None and tuple(out.shape[1:]) != tuple(out_shape):
        raise ValueError(f"last stage's output {tuple(out.shape[1:])}, "
                         f"out_shape {tuple(out_shape)}")
    if out_dtype is not None and out.dtype != out_dtype:
        out = out.to(out_dtype)
    return out


def _pipe_group(group):
    if group is not None:
        return group
    from ..topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_pipe_parallel_group()
    return coll.get_group()


# ---------------------------------------------------------------------------
# the zero-bubble ring (reference :358-633)
# ---------------------------------------------------------------------------

class _ZeroBubble(_Runner):
    """`pipeline_spmd_zb`'s state: `_Runner`'s forward (the inputs kept,
    each application's generator state recorded); a backward whose ring
    ticks compute dX alone, then the dW fold. ``fold(kept, leaves)``
    returns the leaves' grads from the ``{m: (x, dy)}`` pairs the ticks
    kept; ``tick(m, x, dy)`` is a tick's dX (default: autograd through a
    recompute over detached leaves)."""

    def __init__(self, ring, fn, n_micro, fold, tick=None):
        like = (lambda m: torch.empty(self.x_spec[0], dtype=self.x_spec[1],
                                      device=ring.device))
        super().__init__(ring, [(fn, like)], n_micro)
        self.fold, self.tick = fold, tick or self._tick

    def _tick(self, m, x, dy):
        """dX of micro-batch ``m``: the leaves detached and needing no
        grad, so the recompute's graph holds no weight-gradient node."""
        fn = self.passes[0][0]
        x = x.detach().requires_grad_(True)
        y = self.replay(0, m, fn, [t.detach() for t in self.leaves], x)
        if not y.requires_grad:
            return torch.zeros_like(x)
        return torch.autograd.grad(y, [x], dy)[0]

    def backward(self, dy):
        ring, M = self.ring, self.M
        ins = self.ins[0]
        kept = {}

        def vjp(m, d):
            if d is None:
                return torch.zeros_like(ins[m])
            kept[m] = (ins[m], d)
            return self.tick(m, ins[m], d)

        dys = ring.backward(vjp, list(dy.unbind(0)) if ring.stage == 0
                            else None, M, self.passes[0][1])
        grads = self.fold(kept, self.leaves)
        self.ins = []
        return self.input_grad(dys), grads


def _fp32_fold(leaves, parts):
    """Sum the grads ``parts`` (each a list, None where a leaf has none)
    in fp32; each leaf's grad in its own dtype (None for a leaf that
    needs none, zeros for one no part reached)."""
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           if t.requires_grad else None for t in leaves]
    for part in parts:
        for a, g in zip(acc, part):
            if a is not None and g is not None:
                a.add_(g.float())
    return [None if a is None else a.to(t.dtype)
            for a, t in zip(acc, leaves)]


def zb_linear_pipeline(w, x_micro, *, group=None):
    """The tanh-linear ring with its dW-deferred backward written by hand
    (reference :358-472): `pipeline_spmd`'s contract with ``block_fn =
    lambda w, x: tanh(x @ w)``. ``w`` is this rank's stage ``[d, d]``,
    ``x_micro`` ``[n_micro, mb, d]`` (stage 0's is read); returns
    ``[n_micro, mb, d]``, the same on every rank. A reverse tick
    computes ``dpre = dy * (1 - tanh(pre)^2)`` and ``dinp = dpre @ w.T``
    alone; ``dW`` is one contraction over the kept ``(x, dpre)`` pairs
    after the ring."""
    group = _pipe_group(group)
    ring = Ring(group, x_micro.device)
    pres, dpres = [], {}

    def apply(ls, x):
        pres.append(x @ ls[0])      # the stage runs micro-batches in order
        return torch.tanh(pres[-1])

    def tick(m, x, dy):
        dpre = dy * (1.0 - torch.tanh(pres[m]) ** 2)
        dpres[m] = dpre
        return dpre @ w.detach().t()

    def fold(kept, leaves):
        if not leaves[0].requires_grad:
            return [None]
        if not kept:
            return [torch.zeros_like(leaves[0])]
        ms = sorted(kept)
        xs = torch.stack([kept[m][0] for m in ms]).float()
        ds = torch.stack([dpres[m] for m in ms]).float()
        dw = torch.einsum("tbi,tbo->io", xs.reshape(len(ms), -1,
                                                     xs.shape[-1]),
                          ds.reshape(len(ms), -1, ds.shape[-1]))
        return [dw.to(leaves[0].dtype)]

    run = _ZeroBubble(ring, apply, int(x_micro.shape[0]), fold, tick)
    return _apply(run, x_micro, [w])


def pipeline_spmd_zb(block_fn, stage_params, x_micro, *, group=None,
                     dw_chunk=4):
    """`pipeline_spmd` (``num_chunks`` 1) with the dW-deferred backward
    (reference :475-633): a reverse tick recomputes the stage from its
    kept input over detached leaves and computes dX alone; after the
    ring, the weight grads fold over the rank's ``n_micro`` real
    micro-batches in chunks of ``dw_chunk`` (the chunk's recomputes
    held together, then one grad a micro-batch), summed in fp32 and cast
    to each parameter's dtype. Bubble ticks carry no cotangent, so they
    fold nothing. Each recompute replays its application's generator
    state (the forward's dropout masks; `GPTForCausalLMPipe` refuses
    dropout with the zero-bubble ring all the same, as the reference
    does)."""
    group = _pipe_group(group)
    leaves, unflat = _flatten(stage_params)
    n_micro = int(x_micro.shape[0])
    ring = Ring(group, x_micro.device)
    chunk = max(1, int(dw_chunk))

    def fn(ls, x):
        return block_fn(unflat(list(ls)), x)

    def fold(kept, leaves):
        ms = sorted(kept)
        parts = []
        for c0 in range(0, len(ms), chunk):
            ls = [t.detach().requires_grad_(t.requires_grad)
                  for t in leaves]
            want = [t for t in ls if t.requires_grad]
            if not want:
                break
            ys = [(m, run.replay(0, m, fn, ls, kept[m][0].detach()))
                  for m in ms[c0:c0 + chunk]]
            for m, y in ys:
                if not y.requires_grad:
                    continue
                got = iter(torch.autograd.grad(y, want, kept[m][1],
                                               allow_unused=True))
                parts.append([next(got) if t.requires_grad else None
                              for t in ls])
        return _fp32_fold(leaves, parts)

    run = _ZeroBubble(ring, fn, n_micro, fold)
    return _apply(run, x_micro, leaves)
