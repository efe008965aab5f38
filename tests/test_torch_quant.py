"""Weight-only quantization and the rest of `masked_multihead_attention`
in the PyTorch port, against the JAX package on the same numpy inputs.

* `weight_quantize`: the ints and scales equal to the reference's
  (int8, int4, per channel and grouped 64 / 128) and the same refusals;
  `weight_dequantize` equal too.
* `weight_only_linear_ref` (what the CPU runs, and the card's kernel is
  held to): within 1e-6 of the largest output (fp32) and 8e-3 (bf16: one
  rounding of the output, 2^-8 = 3.9e-3, on either side) of the
  reference's `weight_only_linear`, with and without bias, per channel
  and grouped.
* `WeightOnlyLinear` / `quantize_for_decode`: the reference's parameters
  and swaps.
* `masked_multihead_attention` with a bias, ``src_mask`` of shapes
  ``[1, 1, 1, ms]`` and ``[b, 1, 1, ms]``, ragged and device positions:
  output and cache against the reference within 1e-6.

The kernel itself runs on the card only
(tests/test_torch_kernels_gpu.py).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops.kernels import weight_only as wo

ALGOS = ["weight_only_int8", "weight_only_int4"]
GROUPS = [-1, 64, 128]
FP32_REL, BF16_REL = 1e-6, 8e-3


def _w(k, n, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n)) \
        .astype(np.float32)


def _np(t):
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_quantize_matches_reference(algo, group):
    w = _w(256, 48)
    jqw, js = jq.weight_quantize(paddle.to_tensor(w), algo=algo,
                                 group_size=group)
    tqw, ts = tq.weight_quantize(torch.from_numpy(w), algo=algo,
                                 group_size=group)
    assert tqw.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tqw.shape) == (48, 256)
    np.testing.assert_array_equal(tqw.numpy(), _np(jqw))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    lim = 7 if "int4" in algo else 127
    assert int(tqw.abs().max()) <= lim
    for out_dtype, torch_dtype in (("float32", torch.float32),
                                   ("float16", torch.float16)):
        jd = jq.weight_dequantize(jqw, js, algo=algo, out_dtype=out_dtype)
        td = tq.weight_dequantize(tqw, ts, algo=algo, out_dtype=out_dtype)
        assert td.dtype == torch_dtype and tuple(td.shape) == (256, 48)
        np.testing.assert_array_equal(td.float().numpy(),
                                      _np(jd).astype(np.float32))


@pytest.mark.parametrize("call,match", [
    (dict(algo="int8"), "unsupported quant algo"),
    (dict(group_size=32), "group_size must be"),
    (dict(group_size=128, shape=(192, 8)), "not divisible by group"),
])
def test_weight_quantize_refusals_match_reference(call, match):
    call = dict(call)
    w = _w(*call.pop("shape", (128, 8)))
    for fn, arg in ((jq.weight_quantize, paddle.to_tensor(w)),
                    (tq.weight_quantize, torch.from_numpy(w))):
        with pytest.raises(ValueError, match=match):
            fn(arg, **call)


def _linear_case(m, k, n, group, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    q, s = tq.weight_quantize(torch.from_numpy(_w(k, n, seed + 1)),
                              group_size=group)
    return x, q.numpy(), s.numpy(), b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_weight_only_linear_matches_reference(dtype, group, bias):
    x, q, s, b = _linear_case(5, 256, 40, group, bias)
    tdt = getattr(torch, dtype)
    jx = paddle.to_tensor(x).astype(dtype)
    jy = jq.weight_only_linear(
        jx, paddle.to_tensor(q), bias=None if b is None else
        paddle.to_tensor(b).astype(dtype), weight_scale=paddle.to_tensor(s),
        group_size=group)
    ty = wo.weight_only_linear_ref(
        torch.from_numpy(x).to(tdt), torch.from_numpy(q),
        bias=None if b is None else torch.from_numpy(b).to(tdt),
        weight_scale=torch.from_numpy(s), group_size=group)
    assert ty.dtype == tdt and tuple(ty.shape) == (5, 40)
    want = _np(jy.astype("float32"))
    rel = _rel(ty.float().numpy(), want)
    assert rel <= (FP32_REL if dtype == "float32" else BF16_REL), rel
    # the public entry takes the plain version on CPU tensors
    tz = tq.weight_only_linear(
        torch.from_numpy(x).to(tdt), torch.from_numpy(q),
        bias=None if b is None else torch.from_numpy(b).to(tdt),
        weight_scale=torch.from_numpy(s), group_size=group)
    assert torch.equal(ty, tz)


def test_weight_only_linear_leading_dims_and_refusals():
    x, q, s, _ = _linear_case(6, 64, 24, -1, False)
    x3 = torch.from_numpy(x).reshape(2, 3, 64)
    y = tq.weight_only_linear(x3, torch.from_numpy(q),
                              weight_scale=torch.from_numpy(s))
    assert tuple(y.shape) == (2, 3, 24)
    flat = tq.weight_only_linear(torch.from_numpy(x), torch.from_numpy(q),
                                 weight_scale=torch.from_numpy(s))
    assert torch.equal(y.reshape(6, 24), flat)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    with pytest.raises(ValueError, match="last dim"):
        tq.weight_only_linear(x3[..., :32], qt, weight_scale=st)
    with pytest.raises(TypeError, match="int8"):
        tq.weight_only_linear(x3, qt.float(), weight_scale=st)
    with pytest.raises(ValueError, match="grouped weight_scale"):
        tq.weight_only_linear(x3, qt, weight_scale=torch.ones(3, 24))


def test_gemv_plan_fills_the_card_and_covers_k():
    for n, k in ((2048, 2048), (6144, 2048), (8192, 2048), (2048, 8192),
                 (48, 100), (50304, 2048)):
        ksplit, splits = wo.gemv_plan(n, k, 132)
        assert ksplit % wo.CHUNK == 0 and wo.CHUNK <= ksplit <= wo.MAX_SPLIT
        assert (splits - 1) * ksplit < k <= splits * ksplit
    assert wo.gemv_plan(2048, 2048, 132) == (512, 4)       # 256 blocks
    assert wo.gemv_plan(2048, 8192, 132) == (1024, 8)


@pytest.mark.parametrize("dtype,m,k,group,aligned,want", [
    (torch.bfloat16, 1, 2048, 0, True, "mma"),
    (torch.float16, 16, 2048, 128, True, "mma"),
    (torch.bfloat16, 17, 2048, 0, True, "wgmma"),
    (torch.float16, 1024, 208, 64, True, "wgmma"),
    (torch.float32, 8, 2048, 0, True, "gemv"),
    (torch.float32, 1024, 2048, 0, True, "tiled"),
    (torch.bfloat16, 8, 200, 0, True, "gemv"),       # K off 16
    (torch.bfloat16, 40, 200, 0, True, "tiled"),
    (torch.bfloat16, 8, 2048, 8, True, "gemv"),      # a group off 16
    (torch.float16, 64, 2048, 0, False, "tiled"),    # misaligned
    (torch.bfloat16, 16, 2048, 0, False, "gemv"),
], ids=lambda v: str(v).replace("torch.", ""))
def test_route_is_a_function_of_dtype_rows_k_group_and_alignment(
        dtype, m, k, group, aligned, want):
    assert wo.route(dtype, m, k, group, aligned) == want
    assert want in wo.ROUTES


def test_mma_plan_fills_the_card_and_covers_k():
    for n, k in ((2048, 2048), (6144, 2048), (8192, 2048), (2048, 8192),
                 (48, 208), (50304, 2048), (100, 16)):
        ksplit, splits = wo.mma_plan(n, k, 132)
        assert ksplit % wo.MMA_STEP == 0
        assert wo.MMA_STEP <= ksplit <= wo.MMA_MAX_SPLIT
        assert (splits - 1) * ksplit < k <= splits * ksplit
        blocks = -(-n // wo.MMA_ROWS)
        # two blocks an SM, unless K has no more passes to split
        assert blocks * splits >= 2 * 132 or ksplit == wo.MMA_STEP
    # GPT-3 1.3B's projections, each K split evenly: fc1 / qkv in 4,
    # out_proj in 8 passes of 256, fc2 in 16 of 512
    assert wo.mma_plan(8192, 2048, 132) == (512, 4)
    assert wo.mma_plan(6144, 2048, 132) == (512, 4)
    assert wo.mma_plan(2048, 2048, 132) == (256, 8)
    assert wo.mma_plan(2048, 8192, 132) == (512, 16)


def test_wgmma_plan_tiles_and_splits():
    for m, n, k in ((17, 2048, 2048), (40, 8192, 2048), (64, 2048, 8192),
                    (128, 6144, 2048), (1024, 8192, 2048), (300, 100, 208),
                    (2000, 50304, 2048)):
        bn, kper, splits = wo.wgmma_plan(m, n, k, 132)
        assert bn == (64 if m <= 64 else 128 if m <= 128 else 256)
        steps = -(-k // wo.WGMMA_BK)
        assert (splits - 1) * kper < steps <= splits * kper
        tiles = -(-n // wo.WGMMA_ROWS) * -(-m // bn)
        assert splits == 1 or (tiles * splits <= 132 + tiles and kper >= 4)
    # the prompt pass at batch 8 fills the card with tiles alone; the
    # speculative verify and batch 1's prompt split K
    assert wo.wgmma_plan(1024, 8192, 2048, 132) == (256, 32, 1)
    assert wo.wgmma_plan(40, 8192, 2048, 132) == (64, 16, 2)
    assert wo.wgmma_plan(128, 2048, 2048, 132) == (128, 4, 8)


def _magic_bf16(q):
    """The decode and prompt routes' int8 -> bf16 bits (csrc/weight_only.cu
    `dequant4`): the byte (q + 128) under fp32's 2^23, less 2^23 + 128,
    and the high half of that float."""
    u = (q.astype(np.int32) + 128).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    return f, (f.view(np.uint32) >> 16).astype(np.uint16)


def _magic_fp16(q):
    """The fp16 form: the byte under 1024 in a half, less 1152."""
    u = (q.astype(np.int32) + 128).astype(np.uint16)
    return (np.uint16(0x6400) | u).view(np.float16) - np.float16(1152.0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_the_dequantizer_identity(dtype):
    """For every int8 value and scales drawn from a seed: the byte
    permutes give q exactly in T, and q * s_T, exact in fp32, rounded once
    to T is what `_dequantize` (the plain version) gives. The kernels'
    bf16x2 / half2 fma with -0 is that single rounding."""
    q = np.arange(-128, 128, dtype=np.int8)
    if dtype == torch.bfloat16:
        f, bits = _magic_bf16(q)
        np.testing.assert_array_equal(f, q.astype(np.float32))
        got_q = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    else:
        h = _magic_fp16(q)
        np.testing.assert_array_equal(h.astype(np.float32),
                                      q.astype(np.float32))
        got_q = torch.from_numpy(h)
    assert torch.equal(got_q, torch.from_numpy(q).to(dtype))
    rng = np.random.default_rng(0)
    scales = np.concatenate([
        rng.standard_normal(64) * 0.02, rng.uniform(1e-5, 1e-3, 64),
        np.exp(rng.uniform(-12, 4, 128))]).astype(np.float32)
    qq = torch.from_numpy(np.repeat(q[None, :], scales.size, 0))
    s_t = torch.from_numpy(scales).to(dtype).float()
    exact = got_q.float()[None, :] * s_t[:, None]
    # q has at most 8 significant bits and s_T at most 11: exact in fp32
    assert torch.equal(exact.double(),
                       got_q.double()[None, :] * s_t.double()[:, None])
    want = wo._dequantize(qq, torch.from_numpy(scales), dtype)
    assert torch.equal(exact.to(dtype), want)


@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_linear_layer_matches_reference(algo):
    """`WeightOnlyLinear` from a Linear holding the same weights: the
    reference's parameters (names, values, no gradient) and output."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((32, 24)).astype(np.float32)       # [in, out]
    b = rng.standard_normal((24,)).astype(np.float32)
    jl = paddle.nn.Linear(32, 24)
    jl.weight._data, jl.bias._data = jnp.asarray(w), jnp.asarray(b)
    tl = pnn.Linear(32, 24, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T))
        tl.bias.copy_(torch.from_numpy(b))
    jw, tw = jq.WeightOnlyLinear(jl, algo=algo), tq.WeightOnlyLinear(
        tl, algo=algo)
    jp = dict(jw.named_parameters())
    tp = dict(tw.named_parameters())
    assert sorted(tp) == sorted(jp) == ["bias", "quant_weight",
                                        "weight_scale"]
    for name in ("quant_weight", "weight_scale", "bias"):
        np.testing.assert_array_equal(tp[name].detach().numpy(),
                                      _np(jp[name]))
    assert not tw.quant_weight.requires_grad
    assert not tw.weight_scale.requires_grad
    assert tw.bias is tl.bias
    assert tw.weight_dtype == jw.weight_dtype
    x = rng.standard_normal((3, 32)).astype(np.float32)
    want = _np(jw(paddle.to_tensor(x)))
    got = tw(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) <= FP32_REL


def test_quantize_for_decode_swaps_by_name():
    """Every Linear (torch's and the port's own) whose attribute name is
    in ``include``, nothing else; a second call changes nothing."""
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = torch.nn.Linear(8, 24)
            self.fc1 = pnn.Linear(8, 16, device="cpu")
            self.proj = torch.nn.Linear(8, 8)
            self.lm_head = torch.nn.Linear(8, 4, bias=False)

    m = torch.nn.Sequential(Block(), Block())
    assert tq.quantize_for_decode(m) is m
    for blk in m:
        for name in ("qkv", "fc1", "lm_head"):
            assert isinstance(getattr(blk, name), tq.WeightOnlyLinear)
        assert type(blk.proj) is torch.nn.Linear
    assert m[0].lm_head.bias is None
    before = {n: p for n, p in m.named_parameters()}
    tq.quantize_for_decode(m)
    assert {n: p for n, p in m.named_parameters()} == before
    tq.quantize_for_decode(m, include=("proj",))
    assert isinstance(m[1].proj, tq.WeightOnlyLinear)


# ---------------------------------------------------------------------------
# masked_multihead_attention
# ---------------------------------------------------------------------------

B, NH, MS, D = 3, 2, 10, 4


def _mmha_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 3 * NH * D)).astype(np.float32)
    cache = rng.standard_normal((2, B, NH, MS, D)).astype(np.float32)
    bias = rng.standard_normal((3 * NH * D,)).astype(np.float32)
    return x, cache, bias


MASKS = {"none": None, "shared": (1, 1, 1, MS), "per_row": (B, 1, 1, MS)}
POSITIONS = {"int": 4, "device_scalar": np.int32(6),
             "ragged": np.asarray([2, 7, 5], np.int32),
             "ragged_col": np.asarray([[0], [9], [3]], np.int32)}


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("pos", list(POSITIONS))
def test_masked_multihead_attention_matches_reference(pos, mask, with_bias):
    x, cache, bias = _mmha_inputs()
    p = POSITIONS[pos]
    shape = MASKS[mask]
    m = None if shape is None else np.random.default_rng(1) \
        .standard_normal(shape).astype(np.float32)
    kw = {}
    tkw = {}
    if with_bias:
        kw["bias"] = paddle.to_tensor(bias)
        tkw["bias"] = torch.from_numpy(bias)
    if m is not None:
        kw["src_mask"] = paddle.to_tensor(m)
        tkw["src_mask"] = torch.from_numpy(m)
    jp = p if pos == "int" else paddle.to_tensor(p)
    tp = p if pos == "int" else torch.from_numpy(np.asarray(p))
    jout, jcache = JIF.masked_multihead_attention(
        paddle.to_tensor(x), paddle.to_tensor(cache), sequence_lengths=jp,
        **kw)
    tcache = torch.from_numpy(cache.copy())
    tout, tret = TIF.masked_multihead_attention(
        torch.from_numpy(x), tcache, sequence_lengths=tp, **tkw)
    assert tret is tcache
    np.testing.assert_allclose(tout.numpy(), _np(jout), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tcache.numpy(), _np(jcache))


def test_masked_multihead_attention_refuses_what_the_reference_does():
    x, cache, _ = _mmha_inputs()
    tx, tc = torch.from_numpy(x), torch.from_numpy(cache)
    jx, jc = paddle.to_tensor(x), paddle.to_tensor(cache)
    for kw, err, match in (
            (dict(rotary_tensor=np.zeros(1)), NotImplementedError,
             "rotary"),
            (dict(rotary_emb_dims=1), NotImplementedError, "rotary"),
            (dict(beam_cache_offset=np.zeros(1)), NotImplementedError,
             "beam_cache_offset"),
            (dict(), ValueError, "sequence_lengths is required")):
        with pytest.raises(err, match=match):
            JIF.masked_multihead_attention(jx, jc, **kw)
        with pytest.raises(err, match=match):
            TIF.masked_multihead_attention(tx, tc, **kw)
    with pytest.raises(ValueError, match="needs cache_kv"):
        TIF.masked_multihead_attention(tx, None, sequence_lengths=1)
    # accepted and unused, as in the reference
    TIF.masked_multihead_attention(tx, tc, sequence_lengths=1,
                                   cum_offsets=torch.zeros(B), seq_len=1,
                                   use_neox_rotary_style=True, foo=1)
