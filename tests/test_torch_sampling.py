"""Sampling of the PyTorch port against the JAX reference.

The truncation (temperature, top-k, top-p) must keep exactly the
reference's set of tokens, ties included. The random draw cannot repeat
the reference's bits (threefry vs torch generators), so it is held to
the reference's contract instead: a row's token depends only on its own
logits, seed and position.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

from paddle_tpu.nn.functional.sampling import _truncate_logits as jtrunc
from paddle_tpu_torch.nn.functional.sampling import (
    _truncate_logits, sample_logits_per_slot, slot_seed)


def _tied_logits(seed, rows=6, vocab=50):
    """Random logits rounded to a coarse grid, so values repeat at the
    top-k and top-p boundaries."""
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((rows, vocab)) * 2, 1) \
        .astype(np.float32)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, 1.0), (0.7, 0, 0.9), (1.3, 8, 0.5), (1.0, 50, 0.95),
    (1.0, 64, 1.0), (0.5, 1, 0.3), (1.0, 0, 0.999),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truncation_keeps_the_reference_set(seed, temperature, top_k,
                                            top_p):
    lf = _tied_logits(seed)
    want = np.asarray(jtrunc(jnp.asarray(lf), temperature, top_k, top_p))
    got = _truncate_logits(torch.from_numpy(lf), temperature, top_k,
                           top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    kept = np.isfinite(want)
    np.testing.assert_array_equal(got[kept], want[kept])
    assert kept.any(axis=-1).all()


def test_top_k_ties_all_survive():
    lf = torch.tensor([[3.0, 2.0, 2.0, 2.0, 1.0]])
    out = _truncate_logits(lf, 1.0, 2, 1.0)
    assert torch.isfinite(out).tolist() == [[True, True, True, True,
                                             False]]


def test_greedy_is_argmax():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 32))
                              .astype(np.float32))
    got = sample_logits_per_slot(logits, np.zeros(4), np.zeros(4),
                                 greedy=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.argmax(logits.numpy(), -1))


def test_stream_depends_only_on_seed_and_position():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 32)).astype(np.float32)
    seeds = np.asarray([7, 8, 9, 10], np.int32)
    pos = np.asarray([3, 5, 9, 2], np.int32)
    a = sample_logits_per_slot(torch.from_numpy(logits), seeds, pos,
                               top_k=20, top_p=0.9).numpy()
    perm = [2, 0, 3, 1]
    b = sample_logits_per_slot(torch.from_numpy(logits[perm]),
                               seeds[perm], pos[perm], top_k=20,
                               top_p=0.9).numpy()
    np.testing.assert_array_equal(a[perm], b)
    c = sample_logits_per_slot(torch.from_numpy(logits), seeds, pos,
                               top_k=20, top_p=0.9).numpy()
    np.testing.assert_array_equal(a, c)


def test_position_advances_stream():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((1, 500))
                              .astype(np.float32))
    draws = {int(sample_logits_per_slot(logits, [0], [p])[0])
             for p in range(8)}
    assert len(draws) > 1


def test_draws_follow_the_truncated_distribution():
    """Top-k 2 over logits (2, 1, 0, ...): only tokens 0 and 1 are ever
    drawn, at about their softmax odds e:1."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    draws = [int(sample_logits_per_slot(logits, [s], [0], top_k=2)[0])
             for s in range(400)]
    assert set(draws) <= {0, 1}
    share = draws.count(0) / len(draws)
    assert abs(share - np.e / (np.e + 1)) < 0.08


def test_slot_seed_is_pure_and_spreads():
    assert slot_seed(3, 9) == slot_seed(3, 9)
    seeds = {slot_seed(s, p) for s in range(8) for p in range(8)}
    assert len(seeds) == 64
    assert all(0 <= s < 2 ** 63 for s in seeds)
