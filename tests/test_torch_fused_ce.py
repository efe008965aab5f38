"""Fused LM-head cross entropy of the PyTorch port against the JAX package.

The port's plain versions (`fused_ce_fwd_ref` / `fused_ce_bwd_ref`, what a
CPU tensor runs) and its autograd wrapper are held against the reference's
`fused_cross_entropy` in interpret mode (the Pallas kernel's own CPU
route) and through its XLA tiles, over the case grid of the reference's
tests: a vocab that is a multiple of the tile and one that is not,
``ignore_index`` rows. Inputs are numpy arrays from a seed, handed to
both. Tolerance: atol 1e-5 in fp32 for losses, lse, dh and dW (the same
tiles in the same order, fp32 sums; only the summation order inside a
product differs).

The bf16 forward's walk (256-row vocab tiles, one (m, l, picked) a row
and tile, merged in tile order) is written out in fp32 and held against
the reference's ``_fwd_xla``, labels in the last column, in a padded
column and at ``ignore_index`` included.

The bf16 kernel's walk over vocab chunks is planned in Python
(`plan_chunks`): the chunks cover the vocab in order with a ragged last
one, and the scratch stays within its budget; the walk itself, written
out in fp32 chunk by chunk, gives the reference's gradients.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas import fused_cross_entropy as jfce
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce

ATOL = 1e-5


def _inputs(n, vocab, hidden=32, ii=-100, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, hidden)).astype(np.float32)
    w = (rng.standard_normal((vocab, hidden)) * 0.1).astype(np.float32)
    lbl = rng.integers(0, vocab, (n,))
    lbl[::5] = ii
    return h, w, lbl


# (n, vocab, ignore_index): the reference's grid (tests/test_fused_ce.py)
# plus a vocab that is not a multiple of the 128-column tile, which the
# reference's Pallas kernel refuses and its XLA tiles take
GRID = [(64, 256, -100, "interpret"), (64, 256, -100, "xla"),
        (100, 384, -1, "interpret"), (100, 384, -1, "xla"),
        (37, 300, -100, "xla"), (45, 1000, -1, "xla")]


def _jax_losses(h, w, lbl, ii, impl):
    kw = {"interpret": True} if impl == "interpret" else {
        "use_kernel": False}
    return jfce.fused_cross_entropy(h, w, jnp.asarray(lbl, jnp.int32),
                                    ignore_index=ii, **kw)


@pytest.mark.parametrize("n,vocab,ii,impl", GRID)
def test_loss_and_grads_match_jax(n, vocab, ii, impl):
    """Losses and the gradients of sum(sin(losses)) in hidden and weight:
    the port's autograd wrapper on CPU tensors (plain versions) against
    the reference's custom_vjp."""
    h, w, lbl = _inputs(n, vocab, ii=ii)

    def jloss(hh, ww):
        return jnp.sum(jnp.sin(_jax_losses(hh, ww, lbl, ii, impl)))

    jl = _jax_losses(jnp.asarray(h), jnp.asarray(w), lbl, ii, impl)
    jdh, jdw = jax.grad(jloss, (0, 1))(jnp.asarray(h), jnp.asarray(w))

    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = fce.fused_cross_entropy(th, tw, torch.from_numpy(lbl),
                                 ignore_index=ii)
    torch.sin(tl).sum().backward()
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=0,
                               atol=ATOL)
    assert np.all(tl.detach().numpy()[lbl == ii] == 0.0)


@pytest.mark.parametrize("n,vocab,ii", [(64, 256, -100), (37, 300, -1)])
def test_plain_versions_match_xla_tiles(n, vocab, ii):
    """`fused_ce_fwd_ref` / `fused_ce_bwd_ref` against the reference's
    `_fwd_xla` / `_bwd_xla`, which they transcribe: (losses, lse) and
    (dh, dW) from the same lse and cotangent."""
    h, w, lbl = _inputs(n, vocab, ii=ii, seed=1)
    g = np.random.default_rng(2).random(n).astype(np.float32)
    g_eff = np.where(lbl != ii, g, 0.0).astype(np.float32)
    jl, jlse = jfce._fwd_xla(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(lbl, jnp.int32), 128, ii)
    jdh, jdw = jfce._bwd_xla(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(lbl, jnp.int32), jlse,
                             jnp.asarray(g_eff), 128)
    th, tw, tlbl = (torch.from_numpy(a) for a in (h, w, lbl))
    tl, tlse = fce.fused_ce_fwd_ref(th, tw, tlbl, ii)
    tdh, tdw = fce.fused_ce_bwd_ref(th, tw, tlbl, tlse,
                                    torch.from_numpy(g_eff))
    for got, want in ((tl, jl), (tlse, jlse), (tdh, jdh), (tdw, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("transpose_y", [True, False])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_fused_linear_cross_entropy_matches_jax(transpose_y, reduction):
    """`F.fused_linear_cross_entropy` over [b, s, H] hiddens, with the
    weight as [V, H] (transpose_y) or [H, V]: loss and both gradients
    under a random cotangent."""
    rng = np.random.default_rng(3)
    b, s, hid, vocab, ii = 2, 9, 32, 200, -100
    h = rng.standard_normal((b, s, hid)).astype(np.float32)
    w_vh = (rng.standard_normal((vocab, hid)) * 0.1).astype(np.float32)
    w = w_vh if transpose_y else np.ascontiguousarray(w_vh.T)
    lbl = rng.integers(0, vocab, (b, s))
    lbl[0, ::3] = ii
    cot = rng.standard_normal((b, s) if reduction == "none" else ()) \
        .astype(np.float32)

    jh, jw = paddle.to_tensor(h), paddle.to_tensor(w)
    jh.stop_gradient = jw.stop_gradient = False
    jout = JF.fused_linear_cross_entropy(
        jh, jw, paddle.to_tensor(lbl, dtype="int64"),
        transpose_y=transpose_y, reduction=reduction)
    (jout * paddle.to_tensor(cot)).sum().backward()

    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tout = PF.fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                         transpose_y=transpose_y,
                                         reduction=reduction)
    (tout * torch.from_numpy(cot)).sum().backward()
    assert tuple(tout.shape) == tuple(jout.shape)
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), jh.grad.numpy(), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), rtol=0,
                               atol=ATOL)


def test_ignored_rows_get_exactly_zero_gradients():
    """An ignored row contributes a 0 loss, an exactly zero dh row, and
    nothing to dW: an all-ignored batch gives dW == 0 exactly."""
    h, w, lbl = _inputs(40, 256, ii=-100, seed=4)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    fce.fused_cross_entropy(th, tw, torch.from_numpy(lbl)).sum().backward()
    ign = lbl == -100
    assert np.all(th.grad.numpy()[ign] == 0.0)
    assert np.all(np.abs(th.grad.numpy()[~ign]).sum(1) > 0)

    th.grad = tw.grad = None
    none = torch.full((40,), -100, dtype=torch.long)
    fce.fused_cross_entropy(th, tw, none).sum().backward()
    assert torch.count_nonzero(th.grad) == 0
    assert torch.count_nonzero(tw.grad) == 0


def test_bf16_backward_keeps_the_weight_dtype():
    """bf16 in, bf16 gradients out (dW cast to weight.dtype, as the
    reference's backward does); losses against the reference's bf16
    interpret-mode kernel within 3e-2 (its own bf16 bar)."""
    h, w, lbl = _inputs(32, 256, hidden=16, seed=5)
    th = torch.from_numpy(h).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    tl = fce.fused_cross_entropy(th, tw, torch.from_numpy(lbl))
    tl.sum().backward()
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    jl = jfce.fused_cross_entropy(
        jnp.asarray(th.detach().float().numpy(), jnp.bfloat16),
        jnp.asarray(tw.detach().float().numpy(), jnp.bfloat16),
        jnp.asarray(lbl, jnp.int32), interpret=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=0, atol=3e-2)


def test_cross_entropy_matches_jax():
    """`F.cross_entropy` with hard labels and ignore_index, as the
    pretraining criterion uses it."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((30, 50)).astype(np.float32)
    lbl = rng.integers(0, 50, (30,))
    lbl[::4] = -100
    for reduction in ("none", "mean", "sum"):
        want = JF.cross_entropy(paddle.to_tensor(x),
                                paddle.to_tensor(lbl, dtype="int64"),
                                reduction=reduction)
        got = PF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl),
                               reduction=reduction)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want.numpy()).reshape(
                                       got.shape), rtol=0, atol=ATOL)


def test_token_chunked_route_is_not_ported():
    """Ported since (ROADMAP A3): ``vocab_tiled=False`` takes the
    token-chunked route, an explicit ``n_chunks`` alone keeps the
    vocab-tiled one (as in the reference), and both give the same
    loss."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    lbl = torch.from_numpy(rng.integers(0, 8, 4))
    tiled = PF.fused_linear_cross_entropy(h, w, lbl, n_chunks=2)
    chunked = PF.fused_linear_cross_entropy(h, w, lbl, vocab_tiled=False)
    assert abs(float(tiled) - float(chunked)) < 1e-5


@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_y", [True, False])
def test_token_chunked_route_matches_jax(n_chunks, dtype, transpose_y):
    """``vocab_tiled=False`` against the reference's token-chunked
    custom VJP on the same inputs: per-token losses under a random
    cotangent, dh and dW, with the head as [V, H] or [H, V], 38 tokens
    over 1 or 4 chunks (the last one short). fp32 within ATOL; in bf16
    (``d`` rounded to the hidden states' dtype, dW summed over chunks in
    fp32 and cast) the losses within ATOL and both gradients bit for bit
    (as measured)."""
    rng = np.random.default_rng(3)
    b, s, hid, vocab = 2, 19, 32, 200
    h = rng.standard_normal((b, s, hid)).astype(np.float32)
    w_vh = (rng.standard_normal((vocab, hid)) * 0.1).astype(np.float32)
    w = w_vh if transpose_y else np.ascontiguousarray(w_vh.T)
    lbl = rng.integers(0, vocab, (b, s))
    lbl[0, ::3] = -100
    cot = rng.standard_normal((b, s)).astype(np.float32)

    jh, jw = paddle.to_tensor(h).astype(dtype), paddle.to_tensor(w).astype(
        dtype)
    jh.stop_gradient = jw.stop_gradient = False
    jout = JF.fused_linear_cross_entropy(
        jh, jw, paddle.to_tensor(lbl, dtype="int64"),
        transpose_y=transpose_y, reduction="none", n_chunks=n_chunks,
        vocab_tiled=False)
    (jout * paddle.to_tensor(cot)).sum().backward()

    th = torch.from_numpy(h).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_()
    tout = PF.fused_linear_cross_entropy(
        th, tw, torch.from_numpy(lbl), transpose_y=transpose_y,
        reduction="none", n_chunks=n_chunks, vocab_tiled=False)
    (tout * torch.from_numpy(cot)).sum().backward()

    def host(t):
        return np.asarray(t.astype("float32").numpy())

    assert th.grad.dtype == tw.grad.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(tout.detach().numpy(), host(jout), rtol=0,
                               atol=ATOL)
    for got, want in ((th.grad, jh.grad), (tw.grad, jw.grad)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), host(want), rtol=0,
                                       atol=ATOL)
        else:
            np.testing.assert_array_equal(got.float().numpy(), host(want))


def _scratch(n, hidden, width, n_chunks):
    """The bf16 backward's device scratch: the d chunk [n, width] bf16 and,
    with more than one chunk, the dh sums [n, hidden] fp32."""
    return n * width * 2 + (n * hidden * 4 if n_chunks > 1 else 0)


# (n, vocab, hidden, budget): GPT-3 1.3B's training shape at the default
# budget, and ragged shapes over several chunks
PLANS = [(8192, 50304, 2048, None), (300, 612, 64, 300 * 64 * 4 + 300 * 512),
         (1000, 3000, 512, 1000 * 512 * 4 + 1000 * 768 * 2),
         (17, 130, 48, None), (40, 700, 2048, None),
         (4096, 50304, 4096, 96 << 20)]


@pytest.mark.parametrize("n,vocab,hidden,budget", PLANS)
def test_plan_chunks_cover_the_vocab_within_budget(monkeypatch, n, vocab,
                                                   hidden, budget):
    if budget is not None:
        monkeypatch.setattr(fce, "SCRATCH_BYTES", budget)
    width, chunks = fce.plan_chunks(n, vocab, hidden)
    assert width % fce.CHUNK_TILE == 0 and width > 0
    assert chunks[0][0] == 0
    for (v0, rows), (v1, _) in zip(chunks, chunks[1:]):
        assert rows == width and v1 == v0 + rows
    v_last, r_last = chunks[-1]
    assert 0 < r_last <= width and v_last + r_last == vocab
    assert _scratch(n, hidden, width, len(chunks)) <= fce.SCRATCH_BYTES
    # as even as the tile allows: no chunk could be a tile narrower
    tiles = -(-vocab // fce.CHUNK_TILE)
    assert width // fce.CHUNK_TILE == -(-tiles // len(chunks))


def test_plan_chunks_at_the_training_shape():
    """GPT-3 1.3B, 8 x 1024 tokens: five chunks of 10240 rows, the last
    9344; 160 MiB of d chunk and 64 MiB of dh sums."""
    width, chunks = fce.plan_chunks(8192, 50304, 2048)
    assert width == 10240 and len(chunks) == 5
    assert chunks[-1] == (40960, 9344)
    assert _scratch(8192, 2048, width, 5) == 224 << 20


def test_one_chunk_needs_no_dh_sums():
    width, chunks = fce.plan_chunks(64, 1000, 128)
    assert chunks == [(0, 1000)] and width == 1024
    assert _scratch(64, 128, width, 1) == 64 * 1024 * 2


@pytest.mark.parametrize("n,vocab,budget", [(45, 1000, 45 * 32 * 4 + 45 * 512),
                                            (64, 640, 64 * 32 * 4 + 64 * 512)])
def test_chunked_walk_matches_jax_gradients(monkeypatch, n, vocab, budget):
    """The bf16 kernel's algorithm written out in fp32: per chunk, d from
    the chunk's logits (0 past the vocab), dh summed over the chunks in
    order, dW rows of the chunk from d^T h; against the reference's
    `_bwd_xla` on the same lse and cotangent."""
    h, w, lbl = _inputs(n, vocab, seed=3)
    g = np.random.default_rng(4).random(n).astype(np.float32)
    g_eff = np.where(lbl != -100, g, 0.0).astype(np.float32)
    _, jlse = jfce._fwd_xla(jnp.asarray(h), jnp.asarray(w),
                            jnp.asarray(lbl, jnp.int32), 128, -100)
    jdh, jdw = jfce._bwd_xla(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(lbl, jnp.int32), jlse,
                             jnp.asarray(g_eff), 128)
    monkeypatch.setattr(fce, "SCRATCH_BYTES", budget)
    width, chunks = fce.plan_chunks(n, vocab, 32)
    assert len(chunks) > 1 and chunks[-1][1] < width
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    lse = torch.from_numpy(np.array(jlse))
    tl = torch.from_numpy(lbl)[:, None]
    dh = torch.zeros(n, 32)
    dw = torch.zeros(vocab, 32)
    for v0, rows in chunks:
        cols = v0 + torch.arange(width)[None]
        wc = torch.zeros(width, 32)
        wc[:rows] = tw[v0:v0 + rows]
        d = (torch.exp(th @ wc.T - lse[:, None]) - (cols == tl).float()) \
            * torch.from_numpy(g_eff)[:, None]
        d = torch.where(cols < vocab, d, torch.zeros(()))
        dh = dh + d @ wc
        dw[v0:v0 + rows] = (d.T @ th)[:rows]
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=0,
                               atol=ATOL)


def _tile_walk(h, w, lbl, ii, tile=fce.CHUNK_TILE):
    """The bf16 forward kernel's algorithm in fp32: per 256-row vocab
    tile, each row's max, sum of exp(logit - max) and picked logit
    (columns past the vocab -inf; a label in the plain version's padded
    128-wide tile matches there as -inf, one past it matches nothing),
    then the combine over the tiles in order."""
    vocab = w.shape[0]
    v_pad = -(-vocab // fce.BLOCK_V) * fce.BLOCK_V
    lbl = torch.where(lbl >= v_pad, -1, lbl)[:, None]
    parts = []
    for v0 in range(0, vocab, tile):
        cols = v0 + torch.arange(tile)[None]
        wt = torch.zeros(tile, w.shape[1])
        wt[:min(tile, vocab - v0)] = w[v0:v0 + tile]
        x = (h @ wt.T).masked_fill(cols >= vocab, float("-inf"))
        m = x.max(1).values
        parts.append((m, torch.exp(x - m[:, None]).sum(1),
                      torch.where(cols == lbl, x, torch.zeros(())).sum(1)))
    m = torch.stack([p[0] for p in parts]).max(0).values
    l = sum(torch.exp(pm - m) * pl for pm, pl, _ in parts)
    pk = sum(p[2] for p in parts)
    lse = m + torch.log(l)
    return torch.where(lbl[:, 0] != ii, lse - pk, torch.zeros(())), lse


@pytest.mark.parametrize("n,vocab", [(1, 300), (37, 1000), (64, 512),
                                     (20, 130)])
def test_forward_tile_walk_matches_jax(n, vocab):
    """The bf16 forward's tile walk against the reference's ``_fwd_xla``
    on the same inputs: N of 1 and off the 128-row tile, vocabs off the
    256-row tile, labels at ``ignore_index`` and in the vocab's last
    column; a label in a padded column gives the reference's inf loss."""
    h, w, lbl = _inputs(n, vocab, seed=7)
    lbl[-1] = vocab - 1
    if n > 2:
        lbl[1] = vocab + 3          # a padded column of the last tile
    jl, jlse = jfce._fwd_xla(jnp.asarray(h), jnp.asarray(w),
                             jnp.asarray(lbl, jnp.int32), 128, -100)
    tl, tlse = _tile_walk(torch.from_numpy(h), torch.from_numpy(w),
                          torch.from_numpy(lbl), -100)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)


def test_cpu_forward_takes_the_plain_version_without_counting():
    """CPU tensors, fp32 and bf16, take `fused_ce_fwd_ref` and count on
    neither forward route."""
    h, w, lbl = _inputs(24, 300, seed=8)
    before = (fce.fused_ce_fwd.launches, fce.fused_ce_fwd.launches_wgmma)
    for dtype in (torch.float32, torch.bfloat16):
        args = (torch.from_numpy(h).to(dtype), torch.from_numpy(w).to(dtype),
                torch.from_numpy(lbl))
        for got, want in zip(fce.fused_ce_fwd(*args),
                             fce.fused_ce_fwd_ref(*args)):
            assert torch.equal(got, want)
    assert (fce.fused_ce_fwd.launches,
            fce.fused_ce_fwd.launches_wgmma) == before
