"""Quantized paged KV of the PyTorch port against the JAX reference.

The quantizers and the four quantized writers must leave bit-identical
int8 / packed-uint8 pools and fp32 scale pools (trash page included:
both frameworks apply a CPU scatter's duplicates in order). The plain
quantized attention (`paged_attention_ref` / `paged_attention_chunk_ref`
with scales) must agree with the reference's Pallas kernels run in
interpret mode (`_decode_kernel_q`, `_chunk_kernel`'s int8/int4
branches) and with its XLA fallback within 1e-5 in fp32. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_kernels_gpu.py.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.inference import kv_cache as jkv
from paddle_tpu.nn import quant as jquant
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.inference import kv_cache as tkv
from paddle_tpu_torch.nn import quant as tquant
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

ATOL = 1e-5
QUANTS = ["int8", "int4"]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def _rows(qmax, seed=0):
    """[6, 2, 8] fp32: random rows, an all-zero row, and rows whose
    largest value is ``qmax`` (scale exactly 1) holding exact .5 ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 2, 8)).astype(np.float32) * 3
    x[1, 0] = 0.0
    ties = np.asarray([qmax, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -qmax + 0.5],
                      np.float32)
    x[2, 1] = ties
    x[4, 0] = -ties
    return x


@pytest.mark.parametrize("axis", [-1, 1])
def test_q8_matches_reference(axis):
    x = _rows(127.0)
    jq, js = jcoll.quantize_symmetric_q8(jnp.asarray(x), axis=axis)
    tq, ts = tcoll.quantize_symmetric_q8(torch.from_numpy(x), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the ties round half to even, the zero row stays zero with a finite
    # scale
    if axis == -1:
        np.testing.assert_array_equal(tq.numpy()[2, 1],
                                      [127, 0, 2, 2, 0, -2, -2, -126])
        assert (tq.numpy()[1, 0] == 0).all() and ts.numpy()[1, 0] > 0
    np.testing.assert_array_equal(
        tcoll.dequantize_q8(tq, ts, axis=axis).numpy(),
        np.asarray(jcoll.dequantize_q8(jq, js, axis=axis)))


def test_q4_pack_unpack_match_reference():
    x = _rows(7.0, seed=1)
    jq, js = jquant.quantize_symmetric_q4(jnp.asarray(x))
    tq, ts = tquant.quantize_symmetric_q4(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy()[2, 1],
                                  [7, 0, 2, 2, 0, -2, -2, -6])
    tp = tquant.pack_q4(tq)
    jp = jquant.pack_q4(jq)
    assert tp.dtype == torch.uint8 and tuple(tp.shape) == (6, 2, 4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # high nibble is the even lane, offset +8
    assert int(tp[2, 1, 0]) == ((7 + 8) << 4) | (0 + 8)
    np.testing.assert_array_equal(tquant.unpack_q4(tp).numpy(),
                                  np.asarray(jquant.unpack_q4(jp)))
    np.testing.assert_array_equal(tquant.unpack_q4(tp).numpy(), tq.numpy())
    with pytest.raises(ValueError, match="even"):
        tquant.pack_q4(tq[..., :7])


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

KVH, NPAGES, PS, D = 2, 12, 4, 8


def _qpools(quant, rng):
    """Random quantized pools and scale pools, as a cache holds after
    earlier writes."""
    pd = D // 2 if quant == "int4" else D
    shape = (KVH, NPAGES, PS, pd)
    if quant == "int4":
        k = rng.integers(0, 256, shape).astype(np.uint8)
        v = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    ks = rng.random((KVH, NPAGES, PS)).astype(np.float32)
    vs = rng.random((KVH, NPAGES, PS)).astype(np.float32)
    return k, v, ks, vs


def _writers(quant):
    name = "q8" if quant == "int8" else "q4"
    return (getattr(jkv, f"paged_write_decode_{name}"),
            getattr(tkv, f"paged_write_decode_{name}"),
            getattr(jkv, f"paged_write_prefill_{name}"),
            getattr(tkv, f"paged_write_prefill_{name}"))


def _assert_pools_equal(torch_pools, jax_pools):
    for t, j in zip(torch_pools, jax_pools):
        assert t.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.uint8): torch.uint8,
                           np.dtype(np.float32): torch.float32}[
                               np.asarray(j).dtype]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("quant", QUANTS)
def test_quant_decode_write_matches_reference(quant):
    """Slot 0 active mid-page, slot 1 inactive (trash), slot 2 active and
    saturated at the window edge (trash at pos % page_size)."""
    rng = np.random.default_rng(2)
    pools = _qpools(quant, rng)
    pt = np.asarray([[3, 5, 7], [2, 4, 6], [9, 10, 11]], np.int32)
    sl = np.asarray([5, 6, 12], np.int32)
    act = np.asarray([True, False, True])
    kn = rng.standard_normal((3, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((3, KVH, D)).astype(np.float32)
    jwrite, twrite, _, _ = _writers(quant)
    want = jwrite(*_j(*pools, pt, sl, act, kn, vn))
    got = _t(*pools)
    twrite(*got, *_t(pt, sl, act, kn, vn))
    _assert_pools_equal(got, want)
    # slot 0's token (position 5: page 5, offset 1) dequantizes back
    rows = got[0][:, 5, 1]
    deq = (tquant.unpack_q4(rows).float() if quant == "int4"
           else rows.float()) * got[2][:, 5, 1, None]
    tol = 0.5 * float(got[2][:, 5, 1].max())
    np.testing.assert_allclose(deq.numpy(), kn[0], rtol=0, atol=tol)


@pytest.mark.parametrize("quant", QUANTS)
def test_quant_prefill_write_matches_reference(quant):
    """Two live rows (one right-padded) plus a padding row whose slot id
    is max_slots, with and without a chunk start."""
    rng = np.random.default_rng(3)
    max_slots = 3
    pt = np.asarray([[3, 5, 7], [2, 4, 6], [9, 10, 11]], np.int32)
    slot_ids = np.asarray([1, 0, max_slots], np.int32)
    lens_new = np.asarray([3, 8, 0], np.int32)
    s = 4
    kn = rng.standard_normal((3, s, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((3, s, KVH, D)).astype(np.float32)
    _, _, jwrite, twrite = _writers(quant)
    for start in (None, np.asarray([0, 4, 0], np.int32)):
        pools = _qpools(quant, rng)
        extra_j = {} if start is None else {"start": jnp.asarray(start)}
        extra_t = {} if start is None else {"start": torch.from_numpy(start)}
        lens = lens_new if start is not None else np.minimum(lens_new, s)
        want = jwrite(*_j(*pools, pt, slot_ids, lens, kn, vn), **extra_j)
        got = _t(*pools)
        twrite(*got, *_t(pt, slot_ids, lens, kn, vn), **extra_t)
        _assert_pools_equal(got, want)


# ---------------------------------------------------------------------------
# plain quantized attention against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _jax_q4(x):
    q, sc = jquant.quantize_symmetric_q4(x)
    return jquant.pack_q4(q), sc


def _attention_inputs(quant, b=3, nh=4, kvh=2, d=8, ps=8, npages=16, pp=4,
                      c=None, seed=0):
    rng = np.random.default_rng(seed)
    qshape = (b, nh, d) if c is None else (b, c, nh, d)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((kvh, npages, ps, d)).astype(np.float32)
    v = rng.standard_normal((kvh, npages, ps, d)).astype(np.float32)
    quantize = (_jax_q4 if quant == "int4"
                else jcoll.quantize_symmetric_q8)
    kq, ks = quantize(jnp.asarray(k))
    vq, vs = quantize(jnp.asarray(v))
    pt = rng.choice(np.arange(1, npages), (b, pp),
                    replace=False).astype(np.int32)
    return q, np.asarray(kq), np.asarray(vq), pt, np.asarray(ks), \
        np.asarray(vs)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("kvh,d", [(2, 8), (4, 32)])
def test_quant_decode_ref_matches_jax(quant, kvh, d):
    """Ragged lens with an empty slot and a full one."""
    q, k, v, pt, ks, vs = _attention_inputs(quant, kvh=kvh, d=d)
    sl = np.asarray([0, 13, 32], np.int32)
    jargs = _j(q, k, v, pt, sl)
    jsc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    want_kernel = np.asarray(jpa.paged_attention(
        *jargs, interpret=True, use_kernel=True, **jsc))
    want_xla = np.asarray(jpa.paged_attention_xla(*jargs, **jsc))
    tks, tvs = _t(ks, vs)
    got = tpa.paged_attention(*_t(q, k, v, pt, sl), k_scales=tks,
                              v_scales=tvs)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=ATOL)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("c", [1, 8])
def test_quant_chunk_ref_matches_jax(quant, c):
    q, k, v, pt, ks, vs = _attention_inputs(quant, c=c, seed=1)
    st = np.asarray([0, 7, 32 - c], np.int32)
    jargs = _j(q, k, v, pt, st)
    jsc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    want_kernel = np.asarray(jpa.paged_attention_chunk(
        *jargs, interpret=True, use_kernel=True, **jsc))
    want_xla = np.asarray(jpa.paged_attention_chunk_xla(*jargs, **jsc))
    tks, tvs = _t(ks, vs)
    got = tpa.paged_attention_chunk(*_t(q, k, v, pt, st), k_scales=tks,
                                    v_scales=tvs)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=ATOL)


@pytest.mark.parametrize("quant", QUANTS)
def test_quant_cpu_tensors_take_the_plain_version_without_counting(quant):
    q, k, v, pt, ks, vs = _attention_inputs(quant, c=4)
    st = np.asarray([0, 3, 9], np.int32)
    fn = tpa.paged_attention_chunk
    counters = ("launches", "launches_int8", "launches_int4",
                "launches_wgmma", "launches_wgmma_int8",
                "launches_wgmma_int4")
    before = [getattr(fn, c) for c in counters]
    args = _t(q, k, v, pt, st)
    tks, tvs = _t(ks, vs)
    for q_dtype in (torch.float32, torch.bfloat16):
        args[0] = args[0].to(q_dtype)
        got = fn(*args, k_scales=tks, v_scales=tvs)
        want = tpa.paged_attention_chunk_ref(*args, k_scales=tks,
                                             v_scales=tvs)
        assert torch.equal(got, want)
    assert [getattr(fn, c) for c in counters] == before


def test_quant_wrapper_validates_inputs():
    q, k, v, pt, ks, vs = _attention_inputs("int8")
    sl = np.asarray([1, 2, 3], np.int32)
    tq, tk, tv, tpt, tsl, tks, tvs = _t(q, k, v, pt, sl, ks, vs)
    with pytest.raises(ValueError, match="both"):
        tpa.paged_attention(tq, tk, tv, tpt, tsl, k_scales=tks)
    with pytest.raises(TypeError, match="float32"):
        tpa.paged_attention(tq, tk, tv, tpt, tsl, k_scales=tks.double(),
                            v_scales=tvs.double())
    with pytest.raises(ValueError, match="num_pages, page_size"):
        tpa.paged_attention(tq, tk, tv, tpt, tsl,
                            k_scales=tks[..., None].contiguous(),
                            v_scales=tvs[..., None].contiguous())
    with pytest.raises(ValueError, match="num_pages, page_size"):
        tpa.paged_attention(tq, tk, tv, tpt, tsl,
                            k_scales=tks[:, :-1].contiguous(),
                            v_scales=tvs[:, :-1].contiguous())
    with pytest.raises(TypeError, match="need k_scales"):
        tpa.paged_attention(tq, tk, tv, tpt, tsl)
    with pytest.raises(TypeError, match="int8 or uint8"):
        tpa.paged_attention(tq, tk.float(), tv.float(), tpt, tsl,
                            k_scales=tks, v_scales=tvs)
    # int4: an odd head_dim cannot pack two values a byte
    q4 = torch.zeros(3, 4, 7)
    p4 = torch.zeros(2, 16, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="even head_dim"):
        tpa.paged_attention(q4, p4, p4, tpt, tsl, k_scales=tks,
                            v_scales=tvs)
    # a uint8 pool of head_dim (not head_dim // 2) bytes is refused
    p8 = torch.zeros(2, 16, 8, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="shape"):
        tpa.paged_attention(tq, p8, p8, tpt, tsl, k_scales=tks,
                            v_scales=tvs)
