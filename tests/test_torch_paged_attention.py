"""Paged attention of the PyTorch port against the JAX reference.

The port's plain versions (`paged_attention_ref`,
`paged_attention_chunk_ref`) must agree with the reference's Pallas
kernels run in interpret mode and with its XLA gather paths, on the
same numpy inputs, within 1e-5 (fp32; only the summation order
differs). The wrappers route CPU tensors to the plain versions; the
CUDA kernels themselves are checked against them on the card by
tests/test_torch_kernels_gpu.py.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

ATOL = 1e-5


def _inputs(b=3, nh=4, kvh=2, d=32, ps=16, npages=16, pp=4, c=None,
            seed=0):
    rng = np.random.default_rng(seed)
    qshape = (b, nh, d) if c is None else (b, c, nh, d)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((kvh, npages, ps, d)).astype(np.float32)
    v = rng.standard_normal((kvh, npages, ps, d)).astype(np.float32)
    pt = rng.choice(np.arange(1, npages), (b, pp),
                    replace=False).astype(np.int32)
    return q, k, v, pt


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("lens", [(37, 1, 64), (0, 5, 64), (16, 17, 33)])
@pytest.mark.parametrize("kvh", [2, 4])
def test_decode_ref_matches_jax(lens, kvh):
    q, k, v, pt = _inputs(kvh=kvh)
    sl = np.asarray(lens, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, pt, sl)]
    want_kernel = np.asarray(jpa.paged_attention(
        *jargs, interpret=True, use_kernel=True))
    want_xla = np.asarray(jpa.paged_attention_xla(*jargs))
    got = tpa.paged_attention(*_t(q, k, v, pt, sl)).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL)


@pytest.mark.parametrize("start", [(0, 7, 40), (3, 0, 48)])
@pytest.mark.parametrize("c", [1, 8])
def test_chunk_ref_matches_jax(start, c):
    q, k, v, pt = _inputs(kvh=2, c=c)
    st = np.asarray(start, np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, pt, st)]
    want_kernel = np.asarray(jpa.paged_attention_chunk(
        *jargs, interpret=True, use_kernel=True))
    want_xla = np.asarray(jpa.paged_attention_chunk_xla(*jargs))
    got = tpa.paged_attention_chunk(*_t(q, k, v, pt, st)).numpy()
    # rows past the slot's context are masked only causally, as in the
    # reference: every row is defined and compared
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL)


def test_empty_slot_gives_exact_zeros():
    q, k, v, pt = _inputs()
    sl = np.asarray([0, 5, 0], np.int32)
    got = tpa.paged_attention(*_t(q, k, v, pt, sl))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert torch.isfinite(got).all()


def test_scale_argument_matches_jax():
    q, k, v, pt = _inputs()
    sl = np.asarray([9, 30, 64], np.int32)
    want = np.asarray(jpa.paged_attention_xla(
        *[jnp.asarray(a) for a in (q, k, v, pt, sl)], scale=0.3))
    got = tpa.paged_attention(*_t(q, k, v, pt, sl), scale=0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fn,lens", [
    (tpa.paged_attention, "seq_lens"),
    (tpa.paged_attention_chunk, "start"),
])
def test_quantized_pools_not_ported(fn, lens):
    """int8 pools with unit scales attend exactly as the fp pools holding
    the same integer values (the quantized paths themselves are held
    against the reference in tests/test_torch_kv_quant.py)."""
    q, k, v, pt = _inputs(c=None if lens == "seq_lens" else 2)
    kq = np.clip(np.round(k * 20), -127, 127).astype(np.int8)
    vq = np.clip(np.round(v * 20), -127, 127).astype(np.int8)
    pos = np.asarray([0, 9, 40], np.int32)
    scales = torch.ones(k.shape[:3])
    got = fn(*_t(q, kq, vq, pt, pos), k_scales=scales, v_scales=scales)
    want = fn(*_t(q, kq.astype(np.float32), vq.astype(np.float32), pt, pos))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=ATOL)


def test_wrapper_validates_inputs():
    q, k, v, pt = _inputs()
    sl = np.asarray([1, 2, 3], np.int32)
    tq, tk, tv, tpt, tsl = _t(q, k, v, pt, sl)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention(tq, tk, tv, tpt.long(), tsl)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tpa.paged_attention(tq.double(), tk, tv, tpt, tsl)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_attention(tq.transpose(0, 1).contiguous()
                            .transpose(0, 1), tk, tv, tpt, tsl)
    with pytest.raises(ValueError, match="shape"):
        tpa.paged_attention(tq, tk, tv, tpt, tsl[:2])
    with pytest.raises(ValueError, match="multiple"):
        tpa.paged_attention(tq[:, :3].contiguous(), tk, tv, tpt, tsl)


_COUNTERS = ("launches", "launches_int8", "launches_int4", "launches_wgmma",
             "launches_wgmma_int8", "launches_wgmma_int4", "launches_split",
             "launches_split_int8", "launches_split_int4")


def _counts():
    return [getattr(fn, c, None) for c in _COUNTERS
            for fn in (tpa.paged_attention, tpa.paged_attention_chunk)]


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, pt = _inputs(c=4)
    st = np.asarray([0, 3, 9], np.int32)
    before = _counts()
    tq, tk, tv, tpt, tst = _t(q, k, v, pt, st)
    for dtype in (torch.float32, torch.bfloat16):
        args = (tq.to(dtype), tk.to(dtype), tv.to(dtype), tpt, tst)
        got = tpa.paged_attention_chunk(*args)
        want = tpa.paged_attention_chunk_ref(*args)
        assert torch.equal(got, want)
    assert _counts() == before


def test_cpu_decode_takes_the_plain_version_without_counting():
    """Decode on CPU tensors, over fp and int8 pools, is the plain
    version and counts on no route (the split route's counters
    included)."""
    q, k, v, pt = _inputs()
    sl = np.asarray([0, 9, 64], np.int32)
    before = _counts()
    tq, tk, tv, tpt, tsl = _t(q, k, v, pt, sl)
    for dtype in (torch.float32, torch.bfloat16):
        args = (tq.to(dtype), tk.to(dtype), tv.to(dtype), tpt, tsl)
        assert torch.equal(tpa.paged_attention(*args),
                           tpa.paged_attention_ref(*args))
    kq = torch.from_numpy(np.clip(np.round(k * 20), -127, 127)
                          .astype(np.int8))
    scales = torch.full(k.shape[:3], 0.05)
    got = tpa.paged_attention(tq, kq, kq, tpt, tsl, k_scales=scales,
                              v_scales=scales)
    assert torch.equal(got, tpa.paged_attention_ref(
        tq, kq, kq, tpt, tsl, k_scales=scales, v_scales=scales))
    assert _counts() == before


def _pool(shape, dtype, offset=0):
    """A zero pool of ``shape`` starting ``offset`` elements into its
    storage (off the allocation's alignment)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# (q dtype, pool dtype, head_dim, pool offset, q offset) -> route: the
# warpgroup kernel takes a bf16 q over bf16, int8 or int4 (uint8) pools
# with head_dim a multiple of 8 up to 128, q 16-byte and the pools
# 4-byte aligned; every other call the pages kernels
@pytest.mark.parametrize("q_dtype,pool_dtype,d,pool_off,q_off,route", [
    (torch.bfloat16, torch.bfloat16, 64, 0, 0, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 128, 0, 0, "wgmma"),
    (torch.bfloat16, torch.bfloat16, 8, 0, 0, "wgmma"),
    (torch.bfloat16, torch.int8, 64, 0, 0, "wgmma"),
    (torch.bfloat16, torch.int8, 16, 4, 0, "wgmma"),
    (torch.bfloat16, torch.uint8, 16, 0, 0, "wgmma"),
    (torch.float32, torch.float32, 64, 0, 0, "pages"),
    (torch.float32, torch.int8, 64, 0, 0, "pages"),
    (torch.bfloat16, torch.float32, 64, 0, 0, "pages"),
    (torch.bfloat16, torch.bfloat16, 256, 0, 0, "pages"),
    (torch.bfloat16, torch.bfloat16, 12, 0, 0, "pages"),
    (torch.bfloat16, torch.bfloat16, 64, 1, 0, "pages"),
    (torch.bfloat16, torch.int8, 64, 3, 0, "pages"),
    (torch.bfloat16, torch.bfloat16, 64, 0, 1, "pages")])
def test_chunk_route_gate(q_dtype, pool_dtype, d, pool_off, q_off, route):
    """`chunk_route`, the host-side choice between the chunk's two CUDA
    routes, read without a card from dtypes, head_dim and addresses."""
    quant = {torch.int8: "int8", torch.uint8: "int4"}.get(pool_dtype)
    pd = d // 2 if quant == "int4" else d
    q = _pool((2, 4, 4, d), q_dtype, q_off)
    k = _pool((2, 9, 16, pd), pool_dtype, pool_off)
    v = _pool((2, 9, 16, pd), pool_dtype, pool_off)
    assert tpa.chunk_route(q, k, v, quant) == route


# (q dtype, pool dtype, head_dim, page size, pool offset, scale offset) ->
# route: the split-K kernel takes fp32 or bf16 q over fp32, bf16, int8
# or int4 (uint8) pools with head_dim a multiple of 8 up to 256, a page's
# bytes whole 16-byte words (quantized: page size a multiple of 4), pools
# and scales 16-byte aligned and two pages in a block's shared memory;
# every other decode the pages kernels
@pytest.mark.parametrize("q_dtype,pool_dtype,d,ps,pool_off,scale_off,route", [
    (torch.bfloat16, torch.bfloat16, 64, 16, 0, 0, "split"),
    (torch.float32, torch.float32, 64, 16, 0, 0, "split"),
    (torch.float32, torch.bfloat16, 256, 16, 0, 0, "split"),
    (torch.bfloat16, torch.float32, 8, 16, 0, 0, "split"),
    (torch.bfloat16, torch.bfloat16, 24, 8, 8, 0, "split"),
    (torch.bfloat16, torch.int8, 64, 16, 0, 0, "split"),
    (torch.float32, torch.int8, 16, 4, 16, 4, "split"),
    (torch.bfloat16, torch.uint8, 16, 16, 0, 0, "split"),
    (torch.bfloat16, torch.uint8, 256, 32, 0, 0, "split"),
    (torch.bfloat16, torch.bfloat16, 12, 16, 0, 0, "pages"),
    (torch.bfloat16, torch.bfloat16, 64, 16, 1, 0, "pages"),
    (torch.float32, torch.float32, 64, 16, 2, 0, "pages"),
    (torch.bfloat16, torch.int8, 64, 16, 4, 0, "pages"),
    (torch.bfloat16, torch.int8, 64, 16, 0, 1, "pages"),
    (torch.bfloat16, torch.int8, 64, 6, 0, 0, "pages"),
    (torch.bfloat16, torch.uint8, 8, 2, 0, 0, "pages"),
    (torch.float32, torch.float32, 256, 128, 0, 0, "pages")])
def test_decode_route_gate(q_dtype, pool_dtype, d, ps, pool_off, scale_off,
                           route):
    """`decode_route`, the host-side choice between the decode's two CUDA
    routes, read without a card from dtypes, shapes and addresses."""
    quant = {torch.int8: "int8", torch.uint8: "int4"}.get(pool_dtype)
    pd = d // 2 if quant == "int4" else d
    q = _pool((3, 4, d), q_dtype)
    k = _pool((2, 5, ps, pd), pool_dtype, pool_off)
    v = _pool((2, 5, ps, pd), pool_dtype, pool_off)
    sc = {}
    if quant is not None:
        sc = {n: _pool((2, 5, ps), torch.float32, scale_off)
              for n in ("k_scales", "v_scales")}
    assert tpa.decode_route(q, k, v, quant, **sc) == route


def _split_keys(seq_len, split, pp, page_size):
    """The key positions split ``split`` of a slot of ``seq_len`` keys
    walks, by the plan the kernel reads (``paged_split.cuh``: pages
    ``[split * per, (split + 1) * per)`` cut at the slot's last key); the
    kernel itself is held to this walk by the card tests' lengths."""
    per, _ = tpa.split_plan(pp, page_size)
    n = max(0, min(seq_len, pp * page_size))
    return range(min(n, split * per * page_size),
                 min(n, (split + 1) * per * page_size))


@pytest.mark.parametrize("pp,ps", [(64, 16), (10, 16), (3, 128), (7, 24),
                                   (1, 16), (9, 32)])
def test_split_plan_walks_each_live_key_once(pp, ps):
    """`split_plan` sizes the split route's grid from the table's width
    alone (about 128 keys a split); each live key lies in exactly one
    live split, in order, the live splits are the first ones, and a slot
    of length 0 has none (split 0 then writes its zeros)."""
    per, splits = tpa.split_plan(pp, ps)
    assert per == max(1, 128 // ps) and splits == -(-pp // per)
    L = pp * ps
    for n in sorted({0, 1, ps - 1, ps, ps + 1, per * ps, per * ps + 1,
                     L - 1, L, L + 5}):
        walks = [_split_keys(n, s, pp, ps) for s in range(splits)]
        assert [key for w in walks for key in w] == list(range(min(n, L)))
        live = [s for s, w in enumerate(walks) if len(w)]
        assert live == list(range(-(-min(n, L) // (per * ps))))
        assert n > 0 or not live
