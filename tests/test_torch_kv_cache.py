"""Paged KV cache of the PyTorch port against the JAX reference.

The host bookkeeping (capacity probes, atomic rollback, lowest-free-slot
allocation) repeats the reference's own cases; the writers must leave
the pools bit-identical to the reference's after the same writes,
trash-page routing included: inactive slots, right padding, padding
rows whose slot id is out of range (the reference's gather clamps it)
and a decode slot saturated at the window edge (the reference's
out-of-range page lookup lands on page 0 by int32 overflow).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu_torch.inference import kv_cache as tkv
from paddle_tpu_torch.inference.kv_cache import PagedKVCache


def _cache(num_pages=9, max_slots=2, pages_per_seq=4, page_size=8):
    return PagedKVCache(num_layers=1, num_kv_heads=2, head_dim=4,
                        num_pages=num_pages, page_size=page_size,
                        max_slots=max_slots, pages_per_seq=pages_per_seq,
                        device="cpu")


def _snapshot(c):
    return (np.array(c.page_tables), np.array(c.seq_lens),
            np.array(c.active), list(c._free_pages), list(c._free_slots),
            {k: list(v) for k, v in c._slot_pages.items()})


def _assert_unchanged(c, snap):
    pt, sl, act, fp, fs, sp = snap
    np.testing.assert_array_equal(np.asarray(c.page_tables), pt)
    np.testing.assert_array_equal(np.asarray(c.seq_lens), sl)
    np.testing.assert_array_equal(np.asarray(c.active), act)
    assert c._free_pages == fp
    assert c._free_slots == fs
    assert {k: list(v) for k, v in c._slot_pages.items()} == sp


class TestCapacityProbes:
    def test_can_allocate_matches_allocate(self):
        c = _cache()
        assert c.can_allocate(8 * 4)
        assert not c.can_allocate(8 * 4 + 1)
        s0 = c.allocate(8 * 4)
        assert c.can_allocate(32)
        s1 = c.allocate(32)
        assert not c.can_allocate(1)
        c.free(s1)
        assert c.can_allocate(32) and not c.can_allocate(33)
        c.free(s0)

    def test_can_reserve(self):
        c = _cache()
        s = c.allocate(8)
        assert c.can_reserve(s, 32)
        assert not c.can_reserve(s, 33)
        assert not c.can_reserve(999, 8)
        other = c.allocate(8 * 4)
        assert c.can_reserve(s, 32)
        c.free(other)

    def test_failed_allocate_is_atomic(self):
        c = _cache()
        c.allocate(8 * 3)
        snap = _snapshot(c)
        with pytest.raises(RuntimeError):
            c.allocate(8 * 6)
        _assert_unchanged(c, snap)
        with pytest.raises(RuntimeError):
            c.allocate(8 * 4 + 1)
        _assert_unchanged(c, snap)
        c.allocate(1)
        snap = _snapshot(c)
        with pytest.raises(RuntimeError):
            c.allocate(1)
        _assert_unchanged(c, snap)

    def test_failed_reserve_is_atomic(self):
        c = _cache()
        s0 = c.allocate(8)
        s1 = c.allocate(8 * 4)
        snap = _snapshot(c)
        with pytest.raises(RuntimeError, match="exceeds"):
            c.reserve(s0, 8 * 4 + 8)
        _assert_unchanged(c, snap)
        c.free(s1)
        c2 = _cache(num_pages=4, pages_per_seq=4)
        sa = c2.allocate(8)
        c2.allocate(8)
        snap2 = _snapshot(c2)
        with pytest.raises(RuntimeError, match="exhausted"):
            c2.reserve(sa, 8 * 3)
        _assert_unchanged(c2, snap2)

    def test_probes_do_not_mutate(self):
        c = _cache()
        s = c.allocate(8)
        snap = _snapshot(c)
        c.can_allocate(64)
        c.can_reserve(s, 64)
        c.pages_needed(100)
        _assert_unchanged(c, snap)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_bookkeeping_matches_reference(quant):
    """The same allocate/reserve/free churn leaves both caches with the
    same slots, page tables and free lists (lowest free slot first), and
    the same pool statistics: bytes a token with the scale pools
    counted, and the capacity against bf16 pools."""
    kw = dict(num_layers=1, num_kv_heads=2, head_dim=4, num_pages=20,
              page_size=4, max_slots=4, pages_per_seq=6, quant=quant)
    j = jkv.PagedKVCache(**kw)
    t = PagedKVCache(**kw, device="cpu")
    for c in (j, t):
        a = c.allocate(5)
        b = c.allocate(9)
        c.allocate(1)
        c.free(a)
        c.reserve(b, 17)
        c.allocate(3)
        c.set_active(b, False)
        c.free(b)
        c.allocate(12)
    for name in ("page_tables", "seq_lens", "active"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                      np.asarray(getattr(t, name)))
    assert j._free_pages == t._free_pages
    assert sorted(j._free_slots) == sorted(t._free_slots)
    js, ts = j.pool_stats(), t.pool_stats()
    assert set(js) == set(ts)
    for key in ("bytes_per_token", "effective_slots_vs_bf16", "page_bytes",
                "pool_bytes", "total_pages", "used_pages", "free_pages",
                "trash_pages", "page_size", "max_contiguous_free",
                "fragmentation", "occupancy", "slot_pages"):
        assert js[key] == ts[key], key
    if quant is not None:
        assert js["kv_dtype"] == ts["kv_dtype"] == quant
    # one layer, K and V, 2 heads: head_dim 4 values (+ a 4-byte scale)
    want = {None: 2 * 2 * 4 * 4, "int8": 2 * 2 * (4 + 4),
            "int4": 2 * 2 * (2 + 4)}[quant]
    assert ts["bytes_per_token"] == want


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_pools_not_ported(quant):
    """Quantized pools allocate with their scale pools, take writes
    through the layer writer, and round-trip `state()` / `load_state()`
    with the scale pools riding along."""
    c = PagedKVCache(2, 2, 8, num_pages=5, page_size=4, max_slots=2,
                     pages_per_seq=2, quant=quant, device="cpu")
    pd = 4 if quant == "int4" else 8
    assert c.quantized and c.pool_head_dim == pd
    assert c.k_layers[0].dtype == (torch.uint8 if quant == "int4"
                                   else torch.int8)
    assert tuple(c.k_layers[1].shape) == (2, 5, 4, pd)
    assert tuple(c.v_scales[1].shape) == (2, 5, 4)
    assert c.k_scales[0].dtype == torch.float32
    slot = c.allocate(6)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.standard_normal((2, 6, 8))
                            .astype(np.float32))
    flat = tkv.prefill_write_index(
        torch.from_numpy(c.page_tables[[slot]]), None,
        torch.tensor([6], dtype=torch.int32), 6, c.page_size)
    tkv.write_layer(c, 1, flat, rows, -rows)
    assert tkv.layer_scales(c, 0) == (c.k_scales[0], c.v_scales[0])
    page = int(c.page_tables[slot, 0])
    assert (c.k_scales[1][:, page] > 0).all()
    assert torch.equal(c.k_scales[1], c.v_scales[1])
    state = c.state()
    assert {"k_scales", "v_scales"} <= set(state)
    other = PagedKVCache(2, 2, 8, num_pages=5, page_size=4, max_slots=2,
                         pages_per_seq=2, quant=quant, device="cpu")
    other.load_state(state)
    for name in ("k_layers", "v_layers", "k_scales", "v_scales"):
        for a, b in zip(getattr(other, name), getattr(c, name)):
            assert torch.equal(a, b)
    fp = PagedKVCache(1, 2, 8, num_pages=4, page_size=4, max_slots=1,
                      pages_per_seq=2, device="cpu")
    assert not fp.quantized and "k_scales" not in fp.state()
    assert tkv.layer_scales(fp, 0) == (None, None)
    with pytest.raises(ValueError, match="even"):
        PagedKVCache(1, 2, 5, num_pages=4, page_size=4, max_slots=1,
                     pages_per_seq=2, quant="int4", device="cpu")
    with pytest.raises(ValueError, match="quant mode"):
        PagedKVCache(1, 2, 8, num_pages=4, page_size=4, max_slots=1,
                     pages_per_seq=2, quant="fp8", device="cpu")


def test_dense_cache_and_prefill_write_match_reference():
    """`dense_write_prefill` writes positions [0, s) of the dense cache
    bit for bit as the reference's does; the cache's state round-trips."""
    rng = np.random.default_rng(4)
    cache_l = rng.standard_normal((2, 3, 2, 10, 4)).astype(np.float32)
    kn = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    vn = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    want = jkv.dense_write_prefill(*[jnp.asarray(a)
                                     for a in (cache_l, kn, vn)])
    got = torch.from_numpy(cache_l.copy())
    tkv.dense_write_prefill(got, torch.from_numpy(kn), torch.from_numpy(vn))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = tkv.DenseKVCache(2, 3, 10, 2, 4, device="cpu")
    j = jkv.DenseKVCache(2, 3, 10, 2, 4)
    assert [tuple(l.shape) for l in c.layers] == \
        [tuple(l.shape) for l in j.layers]
    c.pos = 6
    c.layers[1] = got
    other = tkv.DenseKVCache(2, 3, 10, 2, 4, device="cpu")
    other.load_state(c.state())
    assert other.pos == 6 and other.layer(1) is got


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(1, 2, 4, num_pages=4, page_size=8, max_slots=1,
                     pages_per_seq=2)


# ---------------------------------------------------------------------------
# writers: bit parity with the reference
# ---------------------------------------------------------------------------

KVH, NPAGES, PS, D = 2, 12, 4, 3


def _pools(rng):
    shape = (KVH, NPAGES, PS, D)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_decode_write_matches_reference():
    """Slot 0 active mid-page, slot 1 inactive (trash), slot 2 active
    and saturated at the window edge (pos == pp * page_size, past the
    table: trash page at pos % page_size)."""
    rng = np.random.default_rng(0)
    kp, vp = _pools(rng)
    pt = np.asarray([[3, 5, 7], [2, 4, 6], [9, 10, 11]], np.int32)
    sl = np.asarray([5, 6, 12], np.int32)
    act = np.asarray([True, False, True])
    kn = rng.standard_normal((3, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((3, KVH, D)).astype(np.float32)
    jk, jv = jkv.paged_write_decode(
        *[jnp.asarray(a) for a in (kp, vp, pt, sl, act, kn, vn)])
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tkv.paged_write_decode(tk, tv, *[torch.from_numpy(a)
                                     for a in (pt, sl, act, kn, vn)])
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the saturated slot's row landed on the trash page, offset 12 % 4
    np.testing.assert_array_equal(tk.numpy()[:, 0, 0], kn[2])


def test_prefill_write_matches_reference():
    """Two live rows (one right-padded) plus a padding row whose slot id
    is max_slots: clamped to the last table row, written to trash."""
    rng = np.random.default_rng(1)
    kp, vp = _pools(rng)
    max_slots = 3
    pt = np.asarray([[3, 5, 7], [2, 4, 6], [9, 10, 11]], np.int32)
    slot_ids = np.asarray([1, 0, max_slots], np.int32)
    start = np.asarray([0, 4, 0], np.int32)
    lens_new = np.asarray([3, 8, 0], np.int32)
    s = 4
    kn = rng.standard_normal((3, s, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((3, s, KVH, D)).astype(np.float32)
    jk, jv = jkv.paged_write_prefill(
        *[jnp.asarray(a) for a in (kp, vp, pt, slot_ids, lens_new, kn,
                                   vn)], start=jnp.asarray(start))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tkv.paged_write_prefill(
        tk, tv, *[torch.from_numpy(a)
                  for a in (pt, slot_ids, lens_new, kn, vn)],
        start=torch.from_numpy(start))
    # every page agrees bit for bit, the trash page too: several padding
    # tokens collide there, and on the CPU both frameworks apply a
    # scatter's duplicates in order, so the last one wins in both
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # slot 1 row 0 (3 valid tokens) and slot 0 row 1 (positions 4..7)
    np.testing.assert_array_equal(tk.numpy()[:, 2, :3],
                                  kn[0, :3].transpose(1, 0, 2))
    np.testing.assert_array_equal(tk.numpy()[:, 5, :4],
                                  kn[1].transpose(1, 0, 2))


def test_slot_rows_clamps_like_the_reference():
    pt = np.arange(12, dtype=np.int32).reshape(3, 4)
    sid = np.asarray([0, 2, 3, 7], np.int32)
    want = np.asarray(jnp.asarray(pt)[jnp.asarray(sid)])
    got = tkv.slot_rows(torch.from_numpy(pt), torch.from_numpy(sid))
    np.testing.assert_array_equal(got.numpy(), want)
