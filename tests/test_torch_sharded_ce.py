"""The vocab-parallel fused CE of the port against the JAX package.

The plain versions a CPU tensor runs (`sharded_fused_ce_fwd_ref` /
`sharded_fused_ce_bwd_ref`) against the reference's ``_fwd_xla_sharded``
/ ``_bwd_xla_sharded`` on each shard of W at mp 2 and 4: the shard's
logsumexp (the reference's ``m + log l``) and picked logit, dh and dW,
atol 1e-5 in fp32 (the same 128-column tiles in the same order). The
vocab's shards end in a ragged tile, and labels sit in the next shard's
first ids (they would alias this shard's padded columns, which a
label matching by column reaches) and at ``ignore_index``.

Then `sharded_fused_cross_entropy` itself, in 2 and 4 gloo ranks on the
CPU (`mp_selftest`'s ``sharded_ce`` case, no jax), each rank on its rows
of W with the hiddens' grad summed over the group (Megatron's f):
losses, dh and dW's rows against the reference's unsharded
``fused_cross_entropy`` (its vjp of ``sum(losses * g)``), atol 1e-5.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_cross_entropy as jfce
from paddle_tpu_torch.distributed.mp_selftest import start
from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce

ATOL = 1e-5
# (tokens, vocab, hidden): V/mp ends in a ragged 128-column tile at mp 2
# and 4 (300, 150; 500, 250)
SHAPES = {"v600": (37, 600, 32), "v1000": (24, 1000, 16)}


def _case(n, vocab, hidden, mp, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, hidden)).astype(np.float32)
    w = (rng.standard_normal((vocab, hidden)) * 0.3).astype(np.float32)
    lbl = rng.integers(0, vocab, (n,))
    vloc = vocab // mp
    # the next shard's first ids: local columns vloc.. of this one, past
    # its vocab but inside its last padded tile
    lbl[1::7] = vloc + np.arange(len(lbl[1::7])) % 5
    lbl[::5] = -100
    g = rng.standard_normal(n).astype(np.float32)
    return h, w, lbl, g


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_shard_forward_and_backward_match_the_reference(shape, mp):
    n, vocab, hidden = SHAPES[shape]
    h, w, lbl, g = _case(n, vocab, hidden, mp)
    vloc = vocab // mp
    assert vloc % fce.BLOCK_V
    ref_lse, ref_pk = [], []
    for r in range(mp):
        wl = w[r * vloc:(r + 1) * vloc]
        m, l, pk = jfce._fwd_xla_sharded(
            jnp.asarray(h), jnp.asarray(wl), jnp.asarray(lbl, jnp.int32),
            r * vloc, fce.BLOCK_V, -100)
        want_lse = np.asarray(m) + np.log(np.asarray(l))
        lse, got_pk = fce.sharded_fused_ce_fwd_ref(
            torch.from_numpy(h), torch.from_numpy(wl),
            torch.from_numpy(lbl), r * vloc)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL)
        np.testing.assert_allclose(got_pk.numpy(), np.asarray(pk), atol=ATOL)
        ref_lse.append(want_lse)
        ref_pk.append(np.asarray(pk))
    # the combine, then each shard's backward against the global lse
    mx = np.max(ref_lse, axis=0)
    lse = mx + np.log(np.sum([np.exp(v - mx) for v in ref_lse], axis=0))
    g_eff = np.where(lbl != -100, g, 0.0).astype(np.float32)
    for r in range(mp):
        wl = w[r * vloc:(r + 1) * vloc]
        dh, dw = jfce._bwd_xla_sharded(
            jnp.asarray(h), jnp.asarray(wl), jnp.asarray(lbl, jnp.int32),
            r * vloc, jnp.asarray(lse, jnp.float32), jnp.asarray(g_eff),
            fce.BLOCK_V)
        got_dh, got_dw = fce.sharded_fused_ce_bwd_ref(
            torch.from_numpy(h), torch.from_numpy(wl), torch.from_numpy(lbl),
            r * vloc, torch.from_numpy(lse.astype(np.float32)),
            torch.from_numpy(g_eff))
        np.testing.assert_allclose(got_dh.numpy(), np.asarray(dh), atol=ATOL)
        np.testing.assert_allclose(got_dw.numpy(), np.asarray(dw), atol=ATOL)


def test_labels_outside_the_shard_match_no_column():
    """An alias label (the next shard's first id) on this shard's padded
    columns and ``ignore_index`` both become -1: the picked logit is 0,
    not a padded column's -inf."""
    lbl = torch.tensor([0, 299, 300, 301, 599, -100])
    got = fce.local_labels(lbl, 300, 300)
    assert got.tolist() == [-1, -1, 0, 1, 299, -1]
    h = torch.randn(6, 8)
    w = torch.randn(300, 8)
    _, pk = fce.sharded_fused_ce_fwd_ref(h, w, torch.tensor(
        [300, 350, 400, 450, 500, 599]), 0)
    assert torch.equal(pk, torch.zeros(6))


def test_cpu_tensors_take_the_plain_version_without_counting():
    h, w, lbl, _ = _case(*SHAPES["v600"], 2)
    before = (fce.fused_ce_fwd.launches, fce.fused_ce_fwd.launches_wgmma,
              fce.fused_ce_bwd.launches)
    args = (torch.from_numpy(h), torch.from_numpy(w[:300]),
            torch.from_numpy(lbl), 0)
    for got, want in zip(fce.sharded_fused_ce_fwd(*args),
                         fce.sharded_fused_ce_fwd_ref(*args)):
        assert torch.equal(got, want)
    assert (fce.fused_ce_fwd.launches, fce.fused_ce_fwd.launches_wgmma,
            fce.fused_ce_bwd.launches) == before


def _reference_unsharded(h, w, lbl, g):
    def f(hh, ww):
        losses = jfce.fused_cross_entropy(hh, ww, jnp.asarray(lbl, jnp.int32),
                                          use_kernel=False)
        return losses

    losses, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w))
    dh, dw = vjp(jnp.asarray(g))
    return np.asarray(losses), np.asarray(dh), np.asarray(dw)


@pytest.fixture(scope="module", params=[2, 4], ids=["mp2", "mp4"])
def world(request):
    n = request.param
    cases = {name: dict(zip(("h", "w", "labels", "g"),
                            _case(*SHAPES[name], n, seed=3)))
             for name in SHAPES}
    job = start("sharded_ce", n, {"cases": cases}, timeout=60)
    try:
        ref = {name: _reference_unsharded(c["h"], c["w"], c["labels"],
                                          c["g"])
               for name, c in cases.items()}
    finally:
        ranks = job.wait(deadline=120)
    return n, ranks, ref


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sharded_fused_cross_entropy_over_gloo_ranks(world, shape):
    n, ranks, ref = world
    losses, dh, dw = ref[shape]
    vloc = dw.shape[0] // n
    for r, out in enumerate(ranks):
        got = out[shape]
        np.testing.assert_allclose(got["losses"], losses, atol=ATOL)
        np.testing.assert_allclose(got["dh"], dh, atol=ATOL)
        np.testing.assert_allclose(got["dw"], dw[r * vloc:(r + 1) * vloc],
                                   atol=ATOL)
