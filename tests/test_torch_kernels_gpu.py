"""The port's CUDA kernels against their plain versions: paged attention
over fp, int8 and int4 pools (serving), splash attention, flash attention
(both paths) and the fused cross entropy (training), forward and
backward; the optimizer's multi-tensor norm and Adam update, and the
fused-scan training step that calls the update once a layer chunk; the
weight-only int8 / int4 linear at its edge shapes, the dense
generation graphs over fp32 and int8 weights, and speculative decoding's
graphs (generation and serving) against its eager steps.

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 1e-4 (fp32 accumulation in another order than the
plain version's matmuls), bf16 2e-2 (the output's bf16 rounding, against
the plain version on the same bf16 inputs); gradients relative to the
plain gradient's largest magnitude, with the same two bars. The backward
kernels sum inside one block in a fixed order, so two runs agree bit for
bit.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.kv_cache import quantize_rows
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_cross_entropy as fce
from paddle_tpu_torch.ops.kernels import multi_tensor as mt
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import splash_attention as sa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# lse: fp32 sums in another order; the bf16 forwards on warpgroup products
# also work in log2 units and convert back
TOL_LSE = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b, nh, kvh, d, ps, pp, c=None, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    npages = 1 + b * pp
    qshape = (b, nh, d) if c is None else (b, c, nh, d)
    q = torch.randn(qshape, device=dev, generator=gen)
    k = torch.randn(kvh, npages, ps, d, device=dev, generator=gen)
    v = torch.randn(kvh, npages, ps, d, device=dev, generator=gen)
    pt = (torch.randperm(npages - 1, device=dev, generator=gen) + 1) \
        .to(torch.int32).reshape(b, pp)
    return q, k, v, pt


_PAGED_COUNTERS = ("launches", "launches_int8", "launches_int4",
                   "launches_wgmma", "launches_wgmma_int8",
                   "launches_wgmma_int4", "launches_split",
                   "launches_split_int8", "launches_split_int4")


def _route_counter(kernel, q, k, v, quant, scales=None):
    """The counter a paged call counts on: its route (`pa.chunk_route`,
    `pa.decode_route`), then the pools' mode."""
    if kernel is pa.paged_attention_chunk:
        route = pa.chunk_route(q, k, v, quant)
    else:
        route = pa.decode_route(q, k, v, quant, *(scales or ()))
    name = "launches" if route == "pages" else f"launches_{route}"
    return name if quant is None else f"{name}_{quant}"


def _counts(kernel):
    return {c: getattr(kernel, c) for c in _PAGED_COUNTERS
            if hasattr(kernel, c)}


def _check(kernel, plain, args, q_dtype, kv_dtype):
    q, k, v, pt, pos = args
    args = (q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype), pt, pos)
    counter = _route_counter(kernel, *args[:3], None)
    before = _counts(kernel)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert _counts(kernel) == {**before, counter: before[counter] + 1}
    assert got.dtype == q_dtype and got.shape == q.shape
    want = plain(*args)
    tol = max(TOL[q_dtype], TOL[kv_dtype])
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, err
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("nh,kvh,d,ps", [
    (32, 32, 64, 16), (8, 2, 64, 16), (4, 1, 128, 8), (6, 3, 16, 32),
    (64, 2, 256, 16), (2, 2, 64, 128)])
def test_decode_kernel(cuda, q_dtype, kv_dtype, nh, kvh, d, ps):
    b, pp = 6, 8
    q, k, v, pt = _inputs(cuda, b, nh, kvh, d, ps, pp)
    lens = torch.tensor([0, 1, ps, ps + 1, 3 * ps - 1, pp * ps],
                        dtype=torch.int32, device=cuda)
    got = _check(pa.paged_attention, pa.paged_attention_ref,
                 (q, k, v, pt, lens), q_dtype, kv_dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("nh,kvh,c", [
    (32, 32, 64), (4, 4, 8), (8, 2, 40), (4, 1, 1), (2, 2, 33),
    (16, 1, 5)])
def test_chunk_kernel(cuda, q_dtype, kv_dtype, nh, kvh, c):
    b, d, ps, pp = 3, 64, 16, 8
    q, k, v, pt = _inputs(cuda, b, nh, kvh, d, ps, pp, c=c)
    start = torch.tensor([0, 5, pp * ps - c], dtype=torch.int32,
                         device=cuda)
    if q_dtype == torch.bfloat16:      # the warpgroup route takes them
        assert pa.chunk_route(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                              None) == "wgmma"
    _check(pa.paged_attention_chunk, pa.paged_attention_chunk_ref,
           (q, k, v, pt, start), q_dtype, kv_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("b,nh,kvh,d,ps,pp,c,starts", [
    (4, 32, 32, 64, 16, 64, 64, (0, 64, 300, 960)),
    (3, 16, 1, 64, 16, 8, 5, (0, 5, 123)), (3, 8, 2, 64, 16, 8, 40,
                                            (0, 5, 88)),
    (3, 4, 1, 64, 16, 8, 1, (0, 5, 127)), (3, 4, 2, 128, 16, 8, 64,
                                           (0, 9, 64)),
    (3, 4, 4, 32, 8, 16, 8, (0, 5, 120)), (2, 4, 2, 64, 32, 4, 17,
                                           (0, 111))])
def test_chunk_wgmma_route(cuda, quant, b, nh, kvh, d, ps, pp, c, starts):
    """The chunk's bf16 warpgroup route over bf16, int8 and int4 pools:
    shuffled page tables, starts at 0, mid-page and at the table's end,
    GQA, c of 1 to 64, head dims 32 to 128; against the plain version,
    counted on its own counter and bit-identical on a second call."""
    q, k, v, pt = _inputs(cuda, b, nh, kvh, d, ps, pp, c=c)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    q = q.bfloat16()
    if quant is None:
        k, v, sc = k.bfloat16(), v.bfloat16(), {}
    else:
        (k, ks), (v, vs) = quantize_rows(k, quant), quantize_rows(v, quant)
        sc = {"k_scales": ks, "v_scales": vs}
    chunk = pa.paged_attention_chunk
    counter = _route_counter(chunk, q, k, v, quant)
    assert counter.startswith("launches_wgmma")
    before = _counts(chunk)
    got = chunk(q, k, v, pt, start, **sc)
    again = chunk(q, k, v, pt, start, **sc)
    torch.cuda.synchronize()
    assert _counts(chunk) == {**before, counter: before[counter] + 2}
    want = pa.paged_attention_chunk_ref(q, k, v, pt, start, **sc)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) <= TOL[
        torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [256, 12])
def test_chunk_pages_route_takes_what_the_gate_refuses(cuda, d):
    """A bf16 chunk the warpgroup kernel's gate refuses (head_dim past
    128, or not a multiple of 8) runs on the pages route and counts
    there."""
    q, k, v, pt = _inputs(cuda, 3, 4, 2, d, 16, 4, c=7)
    args = (q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert pa.chunk_route(*args, None) == "pages"
    start = torch.tensor([0, 5, 57], dtype=torch.int32, device=cuda)
    _check(pa.paged_attention_chunk, pa.paged_attention_chunk_ref,
           (q, k, v, pt, start), torch.bfloat16, torch.bfloat16)


@pytest.mark.gpu
def test_decode_is_the_chunk_of_one(cuda):
    """The pages route's decode is its chunk of one, bit for bit (one
    body); the split route agrees with both within fp32's bar."""
    q, k, v, pt = _inputs(cuda, 4, 8, 2, 64, 16, 4)
    lens = torch.tensor([3, 16, 17, 64], dtype=torch.int32, device=cuda)
    dec = pa._launch("paged_decode", q, k, v, pt, lens, (4,), 1 / 8.0,
                     None, None, None)[0]
    chunk = pa.paged_attention_chunk(q[:, None].contiguous(), k, v, pt,
                                     lens - 1)
    split = pa.paged_attention(q, k, v, pt, lens)
    torch.cuda.synchronize()
    assert torch.equal(dec, chunk[:, 0])
    assert float((split - dec).abs().max()) <= TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(12, 0), (64, 1), (8, 3)])
def test_unaligned_rows_take_scalar_loads(cuda, dtype, d, offset):
    """Rows that are not whole 16-byte words (d=12 in bf16) or pools
    that start off a 16-byte boundary load element by element."""
    q, k, v, pt = _inputs(cuda, 3, 4, 2, d, 16, 4)
    shifted = []
    for pool in (k, v):
        flat = torch.zeros(pool.numel() + offset, dtype=dtype, device=cuda)
        view = flat[offset:].view(pool.shape)
        view.copy_(pool)
        shifted.append(view)
    lens = torch.tensor([5, 0, 64], dtype=torch.int32, device=cuda)
    _check(pa.paged_attention, pa.paged_attention_ref,
           (q, shifted[0], shifted[1], pt, lens), dtype, dtype)


def _check_quant(kernel, plain, q, k, v, pt, pos, quant, q_dtype):
    kq, ks = quantize_rows(k, quant)
    vq, vs = quantize_rows(v, quant)
    args = (q.to(q_dtype), kq, vq, pt, pos)
    counter = _route_counter(kernel, *args[:3], quant, (ks, vs))
    before = _counts(kernel)
    got = kernel(*args, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert _counts(kernel) == {**before, counter: before[counter] + 1}
    assert got.dtype == q_dtype and got.shape == q.shape
    want = plain(*args, k_scales=ks, v_scales=vs)
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got).all() and err <= TOL[q_dtype], err
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,d,ps", [
    (32, 32, 64, 16), (8, 2, 64, 16), (4, 1, 128, 8), (6, 3, 16, 32),
    (64, 2, 256, 16), (4, 2, 48, 16)])
def test_quant_decode_kernel(cuda, quant, q_dtype, nh, kvh, d, ps):
    """#2 against its plain version: GQA, an empty slot, and rows whose
    packed int4 bytes (d/2 = 8, 24) are not whole 16-byte words, which
    take the scalar staging path."""
    b, pp = 6, 8
    q, k, v, pt = _inputs(cuda, b, nh, kvh, d, ps, pp)
    lens = torch.tensor([0, 1, ps, ps + 1, 3 * ps - 1, pp * ps],
                        dtype=torch.int32, device=cuda)
    got = _check_quant(pa.paged_attention, pa.paged_attention_ref, q, k, v,
                       pt, lens, quant, q_dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,c,d", [
    (32, 32, 64, 64), (8, 2, 40, 64), (4, 1, 1, 64), (2, 2, 33, 32),
    (16, 1, 5, 16)])
def test_quant_chunk_kernel(cuda, quant, q_dtype, nh, kvh, c, d):
    """#4 against its plain version at the chunk-prefill shapes."""
    b, ps, pp = 3, 16, 8
    q, k, v, pt = _inputs(cuda, b, nh, kvh, d, ps, pp, c=c)
    start = torch.tensor([0, 5, pp * ps - c], dtype=torch.int32,
                         device=cuda)
    _check_quant(pa.paged_attention_chunk, pa.paged_attention_chunk_ref, q,
                 k, v, pt, start, quant, q_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quant_pools_off_16_bytes_take_scalar_loads(cuda, quant):
    """Quantized pools that start off a 16-byte boundary stage element by
    element; decode is the chunk of one."""
    q, k, v, pt = _inputs(cuda, 3, 8, 2, 64, 16, 4)
    lens = torch.tensor([5, 0, 64], dtype=torch.int32, device=cuda)
    pools = []
    for pool in (k, v):
        payload, sc = quantize_rows(pool, quant)
        flat = torch.zeros(payload.numel() + 3, dtype=payload.dtype,
                           device=cuda)
        view = flat[3:].view(payload.shape)
        view.copy_(payload)
        pools += [view, sc]
    kq, ks, vq, vs = pools
    got = pa.paged_attention(q, kq, vq, pt, lens, k_scales=ks, v_scales=vs)
    chunk = pa.paged_attention_chunk(q[:, None].contiguous(), kq, vq, pt,
                                     (lens - 1).clamp(min=0), k_scales=ks,
                                     v_scales=vs)
    torch.cuda.synchronize()
    want = pa.paged_attention_ref(q, kq, vq, pt, lens, k_scales=ks,
                                  v_scales=vs)
    assert float((got - want).abs().max()) <= TOL[torch.float32]
    assert torch.equal(got[0], chunk[0, 0]) and torch.equal(got[2],
                                                            chunk[2, 0])


@pytest.mark.gpu
def test_quantized_cuda_tensors_never_take_the_plain_version(cuda,
                                                             monkeypatch):
    q, k, v, pt = _inputs(cuda, 2, 4, 2, 64, 16, 2)
    lens = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    kq, ks = quantize_rows(k, "int8")
    vq, vs = quantize_rows(v, "int8")

    def refuse(*a, **kw):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(pa, "paged_attention_ref", refuse)
    monkeypatch.setattr(pa, "paged_attention_chunk_ref", refuse)
    counter = _route_counter(pa.paged_attention, q, kq, vq, "int8",
                             (ks, vs))
    n = getattr(pa.paged_attention, counter)
    pa.paged_attention(q, kq, vq, pt, lens, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert getattr(pa.paged_attention, counter) == n + 1
    with pytest.raises(TypeError, match="float32"):
        pa.paged_attention(q, kq, vq, pt, lens, k_scales=ks.double(),
                           v_scales=vs.double())
    with pytest.raises(ValueError, match="even head_dim"):
        pa.paged_attention(q[..., :63].contiguous(),
                           kq[..., :31].contiguous().view(torch.uint8),
                           vq[..., :31].contiguous().view(torch.uint8), pt,
                           lens, k_scales=ks, v_scales=vs)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_serving_and_generate_on_the_card_match_the_cpu(cuda,
                                                                  quant):
    """A tiny fp32 GPT served and generated over int8/int4 pools on the
    card and on the CPU gives the same greedy tokens."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                    num_attention_heads=2, max_position_embeddings=64)
    cpu = GPTForCausalLM(cfg, device="cpu")
    rng = np.random.default_rng(1)
    sd = {n: torch.from_numpy((rng.standard_normal(tuple(t.shape)) * 0.3)
                              .astype(np.float32))
          for n, t in cpu.state_dict().items()}
    cpu.load_state_dict(sd)
    card = GPTForCausalLM(cfg, device=cuda)
    card.load_state_dict(sd)
    prompts = [rng.integers(1, 96, (n,)) for n in (3, 20, 9)]
    ids = rng.integers(1, 96, (3, 12))
    served, generated = [], []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        eng = ServingEngine(model, max_slots=2, max_len=64, page_size=8,
                            chunk_size=16, device=dev, kv_quant=quant)
        hs = [eng.submit(p, 12) for p in prompts]
        eng.run()
        served.append([h.output_tokens for h in hs])
        generated.append(model.generate(ids, 10, use_cache="paged",
                                        kv_quant=quant))
    assert served[0] == served[1]
    assert torch.equal(generated[0], generated[1])


def _decode_pools(k, v, pool):
    """K/V as ``pool`` pools ("int8"/"int4" quantized, else that dtype)
    and their scale keywords."""
    if pool in ("int8", "int4"):
        (kq, ks), (vq, vs) = quantize_rows(k, pool), quantize_rows(v, pool)
        return kq, vq, {"k_scales": ks, "v_scales": vs}
    return k.to(pool), v.to(pool), {}


# the split route's lengths over a table of 20 pages of 16 keys (splits of
# 8 pages): empty, within and at the edges of a page, of a split, the
# table's full width and past it
SPLIT_LENS = (0, 1, 15, 16, 17, 127, 128, 129, 255, 256, 257, 320, 333)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, "int8",
                                  "int4"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,d", [(4, 4, 64), (8, 2, 16), (16, 2, 128),
                                      (8, 1, 256), (6, 3, 64),
                                      (32, 2, 32)])
def test_decode_split_route(cuda, pool, q_dtype, nh, kvh, d):
    """The split-K decode against the plain version over fp32, bf16, int8
    and int4 pools: GQA groups 1, 2, 4, 8 and 16 (two row chunks), head
    dims 16 to 256, shuffled page tables, `SPLIT_LENS`; counted on its
    own counter only, and bit-identical on a second call."""
    b, ps, pp = len(SPLIT_LENS), 16, 20
    q, k, v, pt = _inputs(cuda, b, nh, kvh, d, ps, pp)
    q = q.to(q_dtype)
    k, v, sc = _decode_pools(k, v, pool)
    quant = pool if isinstance(pool, str) else None
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=cuda)
    counter = _route_counter(pa.paged_attention, q, k, v, quant,
                             tuple(sc.values()))
    assert counter.startswith("launches_split")
    before = _counts(pa.paged_attention)
    got = pa.paged_attention(q, k, v, pt, lens, **sc)
    again = pa.paged_attention(q, k, v, pt, lens, **sc)
    torch.cuda.synchronize()
    assert _counts(pa.paged_attention) == {**before,
                                           counter: before[counter] + 2}
    want = pa.paged_attention_ref(q, k, v, pt, lens, **sc)
    tol = max(TOL[q_dtype], TOL.get(pool, TOL[torch.float32]))
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.bfloat16, "int8", "int4"])
def test_decode_split_in_a_cuda_graph(cuda, pool):
    """One split decode captured in a CUDA graph: its replay equals the
    eager call, and a replay after the lengths change on the device (a
    slot shrinking to 0, one growing past a split) equals the eager call
    on the new lengths: the grid never read them on the host."""
    q, k, v, pt = _inputs(cuda, 4, 16, 4, 64, 16, 16)
    q = q.bfloat16()
    k, v, sc = _decode_pools(k, v, pool)
    lens = torch.tensor([0, 17, 200, 256], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                # warm-up off the graph
        eager = pa.paged_attention(q, k, v, pt, lens, **sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, k, v, pt, lens, **sc)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    lens.copy_(torch.tensor([5, 0, 129, 256], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, pa.paged_attention(q, k, v, pt, lens, **sc))
    assert torch.equal(out[1], torch.zeros_like(out[1]))


@pytest.mark.gpu
def test_decode_split_counters_across_growth_graphs_and_streams(
        cuda, monkeypatch):
    """The split route's counters: a capture takes its own (the eager
    buffers are untouched by it), a graph captured before the eager
    buffer grows replays right after it grew, and two streams in flight
    at once keep a buffer each. Every output equals its eager call."""
    monkeypatch.setattr(pa, "_MIN_COUNTERS", 1)   # grow at these sizes
    monkeypatch.setattr(pa, "_split_counters", {})
    small = [t.bfloat16() if t.is_floating_point() else t
             for t in _inputs(cuda, 2, 8, 2, 64, 16, 16)]
    big = [t.bfloat16() if t.is_floating_point() else t
           for t in _inputs(cuda, 12, 16, 8, 64, 16, 16, seed=1)]
    lens_s = torch.tensor([40, 256], dtype=torch.int32, device=cuda)
    lens_b = torch.arange(12, dtype=torch.int32, device=cuda) * 23
    eager_s = pa.paged_attention(*small, lens_s)
    eager_b = pa.paged_attention(*big, lens_b)
    torch.cuda.synchronize()
    pa._split_counters.clear()
    assert torch.equal(pa.paged_attention(*small, lens_s), eager_s)
    buffers = {key: id(buf) for key, buf in pa._split_counters.items()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(*small, lens_s)
    assert {key: id(buf) for key, buf in pa._split_counters.items()} == \
        buffers
    # the eager buffer grows (the old one goes back to the allocator)
    assert torch.equal(pa.paged_attention(*big, lens_b), eager_b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager_s)
    assert torch.equal(pa.paged_attention(*small, lens_s), eager_s)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(3):
        for s in (s1, s2):
            with torch.cuda.stream(s):
                outs.append(pa.paged_attention(*big, lens_b))
    torch.cuda.synchronize()
    assert all(torch.equal(o, eager_b) for o in outs)
    assert {(cuda.index or 0, s.cuda_stream) for s in (s1, s2)} <= {
        (dev.index, stream) for dev, stream in pa._split_counters}


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, "int8",
                                  "int4"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,d", [(32, 32, 64), (8, 2, 128),
                                      (8, 1, 256)])
def test_decode_pages_route_where_the_split_route_runs(cuda, pool, q_dtype,
                                                       nh, kvh, d):
    """The decode's pages route (``paged_decode_kernel`` /
    ``paged_decode_q_kernel``), which serves every geometry the split
    gate refuses, still agrees with the plain version at the geometries
    the split route took over, and a second call is bit-identical."""
    b, ps, pp = len(SPLIT_LENS), 16, 20
    q, k, v, pt = _inputs(cuda, b, nh, kvh, d, ps, pp)
    q = q.to(q_dtype)
    k, v, sc = _decode_pools(k, v, pool)
    quant = pool if isinstance(pool, str) else None
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=cuda)
    args = (q, k, v, pt, lens, (b,), d ** -0.5, sc.get("k_scales"),
            sc.get("v_scales"), quant)
    before = _counts(pa.paged_attention)
    got = pa._launch("paged_decode", *args)[0]
    again = pa._launch("paged_decode", *args)[0]
    torch.cuda.synchronize()
    assert _counts(pa.paged_attention) == before   # not the path's launches
    want = pa.paged_attention_ref(q, k, v, pt, lens, **sc)
    tol = max(TOL[q_dtype], TOL.get(pool, TOL[torch.float32]))
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("kind,d,ps,grp", [(0, 256, 16, 8), (1, 64, 16, 1),
                                           (2, 128, 8, 4), (3, 24, 32, 2)])
def test_decode_split_gate_knows_the_kernels_shared_memory(cuda, kind, d,
                                                           ps, grp):
    """`decode_route`'s shared-memory arithmetic is the kernel's."""
    lib = pa._build.load("paged_attention", pa._SIGNATURES)
    for stages in (1, 2, 4):
        assert pa._split_smem(kind, d, ps, grp, stages) == \
            lib.paged_decode_split_smem(kind, d, ps, grp, stages)


@pytest.mark.gpu
def test_refused_geometry_raises(cuda):
    q, k, v, pt = _inputs(cuda, 2, 4, 4, 320, 8, 2)
    lens = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, k, v, pt, lens)
    with pytest.raises(ValueError, match="different devices"):
        pa.paged_attention(q, k, v, pt, lens.cpu())


@pytest.mark.gpu
def test_serving_on_the_card_matches_the_cpu(cuda):
    """A tiny fp32 GPT served on the card and on the CPU gives the same
    greedy tokens."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(vocab_size=96, hidden_size=32, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=64)
    cpu = GPTForCausalLM(cfg, device="cpu")
    rng = np.random.default_rng(0)
    sd = {n: torch.from_numpy((rng.standard_normal(tuple(t.shape)) * 0.3)
                              .astype(np.float32))
          for n, t in cpu.state_dict().items()}
    cpu.load_state_dict(sd)
    card = GPTForCausalLM(cfg, device=cuda)
    card.load_state_dict(sd)
    prompts = [rng.integers(1, 96, (n,)) for n in (3, 20, 9)]
    out = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        eng = ServingEngine(model, max_slots=2, max_len=64, page_size=8,
                            chunk_size=16, device=dev, decode_burst=2)
        hs = [eng.submit(p, 12) for p in prompts]
        eng.run()
        out.append([h.output_tokens for h in hs])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# training kernels: splash attention, fused cross entropy
# ---------------------------------------------------------------------------

def _rel(got, want):
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale,
                                                                 1e-30)


def _fwd_counter(wrapper, dtype):
    """The launch counter of a splash or tiled flash forward's route, or
    a splash or flash backward's: the bf16 kernels on warpgroup products
    count apart."""
    return "launches_wgmma" if dtype == torch.bfloat16 else "launches"


def _attn_inputs(dev, b, s, h, kvh, d, dtype, docs=None, seed=0):
    """q, k, v as strided views of one packed tensor, and segment ids:
    ``docs`` documents a row at random cuts (the last row one), or with
    ``docs`` a tuple, those document lengths in every row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, h + 2 * kvh, d, device=dev,
                      generator=gen).to(dtype)
    q, k, v = qkv.split([h, kvh, kvh], dim=2)
    seg = None
    if isinstance(docs, tuple):
        seg = torch.tensor(np.repeat(np.arange(len(docs)), docs),
                           dtype=torch.int32, device=dev).repeat(b, 1)
    elif docs:
        rng = np.random.default_rng(seed)
        rows = []
        for i in range(b):
            n = 1 if i == b - 1 else docs      # one row is one document
            cuts = np.sort(rng.choice(np.arange(1, s), n - 1, replace=False))
            rows.append(np.searchsorted(cuts, np.arange(s), side="right"))
        seg = torch.tensor(np.stack(rows), dtype=torch.int32, device=dev)
    return q, k, v, seg


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d,causal,docs", [
    (2, 128, 4, 4, 64, True, None), (2, 200, 4, 2, 64, True, 3),
    (1, 256, 8, 2, 32, False, 3), (2, 96, 2, 1, 64, False, None),
    (1, 130, 4, 4, 16, True, None),
    # the bf16 forward's edges: head dims padded to 64 and 128, lengths
    # off its 128-row items, GQA, key tiles fully masked for some rows
    (2, 208, 4, 4, 80, False, None), (1, 384, 4, 2, 128, True, 3),
    (2, 300, 8, 2, 128, False, None), (1, 384, 4, 2, 64, True,
                                       (130, 170, 84)),
    (3, 520, 6, 3, 48, True, (300, 220))])
def test_splash_kernels(cuda, dtype, b, s, h, kvh, d, causal, docs):
    """Forward (out, lse) and backward (dq, dk, dv) against the plain
    versions (the fp32 backward takes head_dim up to 64, by shared
    memory); strided q/k/v views (one packed tensor) take no copy."""
    q, k, v, seg = _attn_inputs(cuda, b, s, h, kvh, d, dtype, docs)
    assert not q.is_contiguous()
    counter = _fwd_counter(sa.splash_attention_fwd, dtype)
    n_f, n_b = getattr(sa.splash_attention_fwd, counter), \
        getattr(sa.splash_attention_bwd, counter)
    out, lse = sa.splash_attention_fwd(q, k, v, causal, seg)
    torch.cuda.synchronize()
    want, want_lse = sa.splash_attention_ref(q, k, v, causal, seg,
                                             return_lse=True)
    tol = TOL[dtype]
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert float((out.float() - want.float()).abs().max()) <= tol
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert float((lse - want_lse)[fin].abs().max()) <= TOL_LSE[dtype]
    assert getattr(sa.splash_attention_fwd, counter) == n_f + 1
    if not _fp32_bwd_ok(dtype, d):
        return
    dout = torch.randn(out.shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(1)
                       ).to(dtype)
    got = sa.splash_attention_bwd(q, k, v, out, lse, dout, causal, seg)
    torch.cuda.synchronize()
    ref = sa.splash_attention_bwd_ref(q, k, v, out, lse, dout, causal, seg)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _rel(g, r) <= tol
    again = sa.splash_attention_bwd(q, k, v, out, lse, dout, causal, seg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert getattr(sa.splash_attention_bwd, counter) == n_b + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,h,kvh,d,docs", [
    (96, 64, 2, 2, 32, (64, 32)), (300, 200, 4, 2, 64, (120, 80, 100)),
    (260, 130, 4, 1, 128, (100, 30, 130))])
def test_splash_empty_rows_are_zero(cuda, dtype, sq, sk, h, kvh, d, docs):
    """Non-causal with sk < sq under segments: rows whose document has no
    key give zero output, lse +inf and zero gradients; the other rows
    match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, sq, h, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(1, sk, kvh, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(1, sk, kvh, d, device=cuda, generator=gen).to(dtype)
    seg = torch.tensor(np.repeat(np.arange(len(docs)), docs)[None],
                       dtype=torch.int32, device=cuda)
    empty = sum(docs[:-1])                  # the last document's rows
    assert empty == sk or empty + docs[-1] == sq
    out, lse = sa.splash_attention_fwd(q, k, v, False, seg)
    want, want_lse = sa.splash_attention_ref(q, k, v, False, seg,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out[:, empty:], torch.zeros_like(out[:, empty:]))
    assert torch.isinf(lse[..., empty:]).all()
    assert torch.isfinite(lse[..., :empty]).all()
    assert float((out.float() - want.float()).abs().max()) <= TOL[dtype]
    assert float((lse - want_lse)[..., :empty].abs().max()) <= \
        TOL_LSE[dtype]
    if not _fp32_bwd_ok(dtype, d):
        return
    dq, dk, dv = sa.splash_attention_bwd(q, k, v, out, lse,
                                         torch.ones_like(out), False, seg)
    torch.cuda.synchronize()
    assert torch.equal(dq[:, empty:], torch.zeros_like(dq[:, empty:]))
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,vocab,hidden,budget", [
    (300, 1000, 64, None), (64, 256, 128, None), (17, 130, 48, None),
    (256, 512, 1024, None),
    # the bf16 backward's tile and chunk edges: N off the 128-row tile;
    # three and four vocab chunks, the last ragged with a last dW tile
    # under 128 rows (100 and 696 = 5 x 128 + 56); H 2048 at a small N
    (300, 612, 64, 300 * 64 * 4 + 300 * 256 * 2),
    (1000, 3000, 512, 1000 * 512 * 4 + 1000 * 768 * 2),
    (40, 700, 2048, None)])
def test_fused_ce_kernels(cuda, monkeypatch, dtype, n, vocab, hidden,
                          budget):
    if budget is not None:
        monkeypatch.setattr(fce, "SCRATCH_BYTES", budget)
        assert len(fce.plan_chunks(n, vocab, hidden)[1]) > 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn(n, hidden, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(vocab, hidden, device=cuda, generator=gen) * 0.1) \
        .to(dtype)
    labels = torch.randint(0, vocab, (n,), device=cuda, generator=gen)
    labels[::7] = -100
    counter = _fwd_counter(fce.fused_ce_fwd, dtype)
    n_f, n_b = getattr(fce.fused_ce_fwd, counter), fce.fused_ce_bwd.launches
    loss, lse = fce.fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    want, want_lse = fce.fused_ce_fwd_ref(h, w, labels)
    tol = TOL[dtype]
    assert float((loss - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))
    assert float((lse - want_lse).abs().max()) <= 1e-4 * max(
        1.0, float(want_lse.abs().max()))
    assert torch.equal(loss[::7], torch.zeros_like(loss[::7]))
    g = torch.rand(n, device=cuda, generator=gen)
    g_eff = torch.where(labels != -100, g, torch.zeros_like(g))
    dh, dw = fce.fused_ce_bwd(h, w, labels, lse, g_eff)
    torch.cuda.synchronize()
    rdh, rdw = fce.fused_ce_bwd_ref(h, w, labels, lse, g_eff)
    assert dh.dtype == dtype and dw.dtype == dtype
    assert _rel(dh, rdh) <= tol and _rel(dw, rdw) <= tol
    assert torch.equal(dh[::7], torch.zeros_like(dh[::7]))
    dh2, dw2 = fce.fused_ce_bwd(h, w, labels, lse, g_eff)
    torch.cuda.synchronize()
    assert torch.equal(dh2, dh) and torch.equal(dw2, dw)
    assert getattr(fce.fused_ce_fwd, counter) == n_f + 1
    assert fce.fused_ce_bwd.launches == n_b + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hidden", [(1000, 2048), (300, 4096)])
def test_fused_ce_at_llama_vocab(cuda, dtype, n, hidden):
    """LLaMA's vocab of 32000 (TinyLlama's hidden 2048, LLaMA-7B's 4096)
    through `fused_linear_cross_entropy`, the untied head's ``[vocab,
    hidden]`` weight with ``transpose_y=True``: loss and both gradients
    against the plain version on the same inputs, one forward and one
    backward launch."""
    from paddle_tpu_torch.nn import functional as PF

    vocab = 32000
    gen = torch.Generator(device=cuda).manual_seed(1)
    h = torch.randn(n, hidden, device=cuda, generator=gen).to(dtype)
    w = (torch.randn(vocab, hidden, device=cuda, generator=gen) * 0.02) \
        .to(dtype)
    labels = torch.randint(0, vocab, (n,), device=cuda, generator=gen)
    labels[::9] = -100
    labels[-1] = vocab - 1
    counter = _fwd_counter(fce.fused_ce_fwd, dtype)
    n_f, n_b = getattr(fce.fused_ce_fwd, counter), fce.fused_ce_bwd.launches
    grads = []
    for kernel in (True, False):
        hk, wk = h.clone().requires_grad_(), w.clone().requires_grad_()
        if kernel:
            loss = PF.fused_linear_cross_entropy(hk, wk, labels)
        else:
            losses, _ = fce.fused_ce_fwd_ref(hk, wk, labels)
            loss = losses.sum() / (labels != -100).sum()
        loss.backward()
        grads.append((loss.detach(), hk.grad, wk.grad))
    torch.cuda.synchronize()
    assert getattr(fce.fused_ce_fwd, counter) == n_f + 1
    assert fce.fused_ce_bwd.launches == n_b + 1
    (loss, dh, dw), (want, rdh, rdw) = grads
    assert abs(float(loss) - float(want)) <= 1e-4
    assert _rel(dh, rdh) <= TOL[dtype] and _rel(dw, rdw) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("n,vocab,hidden", [(300, 1000, 64), (1, 300, 128),
                                            (129, 512, 2048), (17, 130, 48),
                                            (256, 50304, 256)])
def test_fused_ce_fwd_wgmma_route(cuda, n, vocab, hidden):
    """The bf16 forward on warpgroup products against the plain version:
    N of 1 and off the 128-row tile, vocabs off (and on) the 256-row
    tile, labels in the last column and at ignore_index; lse within the
    bf16 bar 1e-3, losses 2e-2; counted on ``launches_wgmma`` only and
    bit-identical on a second call."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn(n, hidden, device=cuda, generator=gen).bfloat16()
    w = (torch.randn(vocab, hidden, device=cuda, generator=gen) * 0.1) \
        .bfloat16()
    labels = torch.randint(0, vocab, (n,), device=cuda, generator=gen)
    labels[::5] = -100
    labels[-1] = vocab - 1
    before = (fce.fused_ce_fwd.launches, fce.fused_ce_fwd.launches_wgmma)
    loss, lse = fce.fused_ce_fwd(h, w, labels)
    loss2, lse2 = fce.fused_ce_fwd(h, w, labels)
    torch.cuda.synchronize()
    assert (fce.fused_ce_fwd.launches,
            fce.fused_ce_fwd.launches_wgmma) == (before[0], before[1] + 2)
    want, want_lse = fce.fused_ce_fwd_ref(h, w, labels)
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    assert torch.isfinite(loss).all() and torch.isfinite(lse).all()
    assert float((lse - want_lse).abs().max()) <= TOL_LSE[torch.bfloat16]
    assert float((loss - want).abs().max()) <= TOL[torch.bfloat16]
    ignored = labels == -100
    assert torch.equal(loss[ignored], torch.zeros_like(loss[ignored]))


@pytest.mark.gpu
def test_training_kernel_errors(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sa.splash_attention_fwd(q.half(), q.half(), q.half())
    q20 = torch.randn(1, 64, 2, 20, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        sa.splash_attention_fwd(q20, q20, q20)
    with pytest.raises(ValueError, match="equal seq lens"):
        sa.splash_attention_fwd(q, q[:, :32], q[:, :32], True)
    # fp32 backward at head_dim 128 needs more shared memory than a block
    # has: the launch is refused, and the wrapper raises
    q128 = torch.randn(1, 64, 2, 128, device=cuda)
    out, lse = sa.splash_attention_fwd(q128, q128, q128)
    with pytest.raises(RuntimeError, match="launch failed"):
        sa.splash_attention_bwd(q128, q128, q128, out, lse, out)
    h = torch.randn(8, 64, device=cuda)
    lbl = torch.zeros(8, dtype=torch.long, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fce.fused_ce_fwd(h, h.bfloat16(), lbl)
    with pytest.raises(ValueError, match="multiple of 16"):
        fce.fused_ce_fwd(h[:, :40], h[:, :40].contiguous(), lbl)
    with pytest.raises(ValueError, match="contiguous"):
        fce.fused_ce_fwd(h, torch.randn(64, 16, device=cuda).T, lbl)
    # a geometry the kernel refuses (no vocab tiles a split) returns an
    # error code before any launch, and the runner raises
    loss, lse = torch.empty(8, device=cuda), torch.empty(8, device=cuda)
    part = torch.empty(3, 8, device=cuda)
    lbl32 = lbl.to(torch.int32)
    with pytest.raises(RuntimeError, match="launch failed"):
        fce._run("fused_ce_fwd", h.data_ptr(), h.data_ptr(),
                 lbl32.data_ptr(), loss.data_ptr(), lse.data_ptr(), None,
                 part.data_ptr(), 8, 8, 64, -100, 0, 0,
                 torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# flash attention: the single-block pair (#5/#6) and the tiled pair (#7/#8)
# ---------------------------------------------------------------------------

FLASH_CASES = [(2, 128, 4, 64, True), (1, 200, 2, 64, False),
               (2, 96, 3, 16, True), (1, 256, 2, 128, True),
               (1, 130, 2, 32, False)]
# the tiled pair also at the bf16 forward's edges: head dims padded to 64
# and 128, lengths off its 128-row items and 128-key tiles
FLASH_TILED_CASES = FLASH_CASES + [
    (2, 208, 3, 80, True), (1, 384, 2, 128, False), (3, 520, 4, 48, True),
    (1, 1280, 2, 64, True)]
# the single-block pair also at lengths under, at and off the bf16
# kernels' 128-row (and the backward's 64-row) tiles, and at every padded
# head dim
FLASH_SINGLE_CASES = FLASH_CASES + [
    (1, s, 2, d, causal) for s in (16, 80, 1008, 1024)
    for d in (16, 32, 64, 128) for causal in (True, False)] + [
    (2, 200, 3, 48, True), (1, 200, 2, 48, False)]


def _flash_inputs(dev, b, s, h, d, dtype, seed=0, sk=None):
    """q, k, v as strided views of one packed tensor, and dout."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, d, device=dev, generator=gen).to(dtype)
    q, k, v = qkv.unbind(2)
    if sk is not None:
        k, v = (torch.randn(b, sk, h, d, device=dev, generator=gen)
                .to(dtype) for _ in range(2))
    dout = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    return q, k, v, dout


def _fp32_bwd_ok(dtype, d):
    return dtype != torch.float32 or d <= 64


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", FLASH_SINGLE_CASES)
def test_flash_single_kernels(cuda, dtype, b, s, h, d, causal):
    """#5 and #6 against their plain versions (exact softmax, P rounded
    after the division); the backward twice, bit for bit, counted in its
    route's counter (bf16: the warpgroup kernels)."""
    q, k, v, dout = _flash_inputs(cuda, b, s, h, d, dtype)
    assert not q.is_contiguous()
    counter = _fwd_counter(fa.flash_attention_bwd_single, dtype)
    n_f, n_b = fa.flash_attention_fwd_single.launches, \
        getattr(fa.flash_attention_bwd_single, counter)
    out = fa.flash_attention_fwd_single(q, k, v, causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_single_ref(q, k, v, causal)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert float((out.float() - want.float()).abs().max()) <= TOL[dtype]
    assert fa.flash_attention_fwd_single.launches == n_f + 1
    if not _fp32_bwd_ok(dtype, d):
        return
    got = fa.flash_attention_bwd_single(q, k, v, dout, causal)
    again = fa.flash_attention_bwd_single(q, k, v, dout, causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_single_bwd_ref(q, k, v, dout, causal)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _rel(g, r) <= TOL[dtype]
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert getattr(fa.flash_attention_bwd_single, counter) == n_b + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,causal", FLASH_TILED_CASES)
def test_flash_tiled_kernels(cuda, dtype, b, s, h, d, causal):
    """#7 (out, lse) and #8 from that out and lse against their plain
    versions (P rounded per 64-key tile, unnormalised; the bf16 forward's
    128-key tiles round within the bf16 tolerance); the backward twice,
    bit for bit. Both entries count bf16 launches (warpgroup kernels)
    apart from fp32 ones."""
    q, k, v, dout = _flash_inputs(cuda, b, s, h, d, dtype)
    counter = _fwd_counter(fa.flash_attention_fwd, dtype)
    n_f, n_b = getattr(fa.flash_attention_fwd, counter), \
        getattr(fa.flash_attention_bwd, counter)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_ref(q, k, v, causal,
                                            return_lse=True)
    assert out.dtype == dtype and torch.isfinite(out).all()
    assert float((out.float() - want.float()).abs().max()) <= TOL[dtype]
    assert torch.isfinite(lse).all()
    assert float((lse - want_lse).abs().max()) <= TOL_LSE[dtype]
    assert getattr(fa.flash_attention_fwd, counter) == n_f + 1
    if not _fp32_bwd_ok(dtype, d):
        return
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and torch.isfinite(g).all()
        assert _rel(g, r) <= TOL[dtype]
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert getattr(fa.flash_attention_bwd, counter) == n_b + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_outside_lse_and_unequal_lengths(cuda, dtype):
    """The ring's contract: q rows against two key blocks of another
    length (plain attention), merged into a global out and lse; each
    block's backward from them matches the plain version, and the
    blocks' dq sum to the whole attention's."""
    q, k, v, dout = _flash_inputs(cuda, 2, 128, 2, 64, dtype, sk=320)
    parts = [(k[:, :192], v[:, :192]), (k[:, 192:], v[:, 192:])]
    fwd = [fa.flash_attention_fwd(q, kk, vv, False) for kk, vv in parts]
    (oa, la), (ob, lb) = fwd
    lse = torch.logaddexp(la, lb)
    out = (oa.float() * torch.exp(la - lse).transpose(1, 2)[..., None]
           + ob.float() * torch.exp(lb - lse).transpose(1, 2)[..., None]) \
        .to(dtype)
    grads = [fa.flash_attention_bwd(q, kk, vv, out, lse, dout, False)
             for kk, vv in parts]
    torch.cuda.synchronize()
    for (kk, vv), gs in zip(parts, grads):
        for g, r in zip(gs, fa.flash_attention_bwd_ref(q, kk, vv, out, lse,
                                                       dout, False)):
            assert _rel(g, r) <= TOL[dtype]
    whole, whole_lse = fa.flash_attention_ref(q, k, v, False,
                                              return_lse=True)
    assert float((lse - whole_lse).abs().max()) <= TOL_LSE[dtype]
    assert float((out.float() - whole.float()).abs().max()) <= TOL[dtype]
    wdq = fa.flash_attention_bwd_ref(q, k, v, whole, whole_lse, dout,
                                     False)[0]
    assert _rel(grads[0][0].float() + grads[1][0].float(), wdq) <= TOL[dtype]


@pytest.mark.gpu
def test_flash_autograd_and_sdpa_route_on_the_card(cuda):
    """`flash_attention` and SDPA with the splash flag off launch the
    flash kernels of the length's path, never the plain versions (256
    tokens with ``FLAGS_pallas_flash_min_seqlen`` lowered to 16; 1280 at
    the default); under the default gate 256 tokens take the dense
    attention and no kernel, as in the reference."""
    import paddle_tpu_torch
    from paddle_tpu_torch.nn import functional as PF

    names = ["FLAGS_splash_attn", "FLAGS_pallas_flash_min_seqlen"]
    saved = paddle_tpu_torch.get_flags(names)
    counters = [(fa.flash_attention_fwd_single, "launches"),
                (fa.flash_attention_bwd_single, "launches_wgmma"),
                (fa.flash_attention_fwd, "launches_wgmma"),
                (fa.flash_attention_bwd, "launches_wgmma")]

    def sdpa(s):
        q, k, v, _ = _flash_inputs(cuda, 1, s, 2, 64, torch.bfloat16)
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        n = [getattr(f, c) for f, c in counters]
        PF.scaled_dot_product_attention(q, k, v, is_causal=True) \
            .float().sum().backward()
        torch.cuda.synchronize()
        assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
        return [getattr(f, c) - m for (f, c), m in zip(counters, n)]

    try:
        paddle_tpu_torch.set_flags({"FLAGS_splash_attn": False})
        assert sdpa(256) == [0, 0, 0, 0]
        assert sdpa(1280) == [0, 0, 1, 1]
        paddle_tpu_torch.set_flags({"FLAGS_pallas_flash_min_seqlen": 16})
        assert sdpa(256) == [1, 1, 0, 0]
    finally:
        paddle_tpu_torch.set_flags(saved)


@pytest.mark.gpu
def test_sdpa_routes_short_and_unblocked_lengths_to_dense_on_the_card(
        cuda):
    """Under the default gate, SDPA on the card runs the dense attention
    below 1024 tokens and where no kernel's block gate takes the length
    (1100), and splash's bf16 forward at 1024, equal to its plain
    version; segment ids go to splash at any length."""
    from paddle_tpu_torch.nn import functional as PF

    for s, launched in ((128, 0), (1100, 0), (1024, 1)):
        q, k, v, _ = _attn_inputs(cuda, 1, s, 4, 4, 64, torch.bfloat16)
        n = sa.splash_attention_fwd.launches_wgmma
        out = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
        assert sa.splash_attention_fwd.launches_wgmma == n + launched
        want = sa.splash_attention_ref(q, k, v, True)
        assert float((out.float() - want.float()).abs().max()) <= 2e-2
    q, k, v, seg = _attn_inputs(cuda, 2, 96, 4, 2, 64, torch.bfloat16,
                                docs=3)
    n = sa.splash_attention_fwd.launches_wgmma
    PF.scaled_dot_product_attention(q, k, v, is_causal=True,
                                    segment_ids=seg)
    torch.cuda.synchronize()
    assert sa.splash_attention_fwd.launches_wgmma == n + 1


@pytest.mark.gpu
def test_flash_refusals_raise_without_a_fallback(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("flash_attention_single_ref",
                 "flash_attention_single_bwd_ref", "flash_attention_ref",
                 "flash_attention_bwd_ref"):
        monkeypatch.setattr(fa, name, refuse)
    q = torch.randn(1, 64, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q.half(), q.half(), q.half())
    q144 = torch.randn(1, 64, 2, 144, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd_single(q144, q144, q144)
    q20 = torch.randn(1, 64, 2, 20, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q20, q20, q20)
    q128 = torch.randn(1, 64, 2, 128, device=cuda)
    out = fa.flash_attention_fwd_single(q128, q128, q128)
    with pytest.raises(ValueError, match="float32 backward"):
        fa.flash_attention_bwd_single(q128, q128, q128, out)
    with pytest.raises(ValueError, match="float32 backward"):
        fa.flash_attention(q128.requires_grad_(), q128, q128)
    with pytest.raises(ValueError, match="equal q/k seq lens"):
        fa.flash_attention_fwd(q, q[:, :32], q[:, :32], True)
    with pytest.raises(ValueError, match="one head count"):
        fa.flash_attention_fwd(q, q[:, :, :1], q[:, :, :1], False)
    with pytest.raises(ValueError, match="unsupported seq lens"):
        x = torch.randn(1, 1040, 2, 64, device=cuda)
        fa.flash_attention(x, x, x)
    out, lse = fa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, out, lse[:, :1], out)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd(q, q, q, out, lse, out[:, :32])
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_single(q, q, q, out.cpu())
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the optimizer's multi-tensor kernels
# ---------------------------------------------------------------------------

# sizes: one element, numel not a multiple of the 8-element vector or of
# the 2048-element chunk, several chunks
MT_SIZES = (1, 7, 2048, 2049, 3 * 2048 + 5, 40000)


def _ulps(got, want, dtype):
    """|got - want| in units of the last place of ``want`` in ``dtype``
    (fp32 or bf16), elementwise, as float64."""
    w = want.double()
    mant = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    tiny = {torch.float32: 2.0 ** -149, torch.bfloat16: 2.0 ** -133}[dtype]
    e = torch.floor(torch.log2(w.abs().clamp(min=tiny)))
    return (got.double() - w).abs() / torch.exp2(e - mant).clamp(min=tiny)


def _adam_state(dev, pdtype, master, mdtype, amsgrad, sizes=MT_SIZES,
                seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(n, dt, scale=1.0, positive=False):
        x = torch.randn(n, device=dev, generator=gen) * scale
        return (x.abs() if positive else x).to(dt)

    ps = [rnd(n, pdtype) for n in sizes]
    return dict(
        params=ps, grads=[rnd(n, pdtype, 3.0) for n in sizes],
        masters=[p.float() if master else None for p in ps],
        exp_avgs=[rnd(n, mdtype, 0.1) for n in sizes],
        exp_avg_sqs=[rnd(n, mdtype, 0.01, True) for n in sizes],
        max_exp_avg_sqs=[rnd(n, mdtype, 0.02, True) for n in sizes]
        if amsgrad else None)


def _clone_state(st):
    return {k: None if v is None else [None if t is None else t.clone()
                                       for t in v] for k, v in st.items()}


def _adam_kw(dev, n, found=False):
    return dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                step=torch.tensor(6, dtype=torch.int32, device=dev),
                lr_scales=[1.0, 0.5, 2.0, 1.0, 0.25, 1.0][:n] +
                [1.0] * max(0, n - 6),
                wds=[0.01, 0.0, 0.1, 0.01, 0.01, 0.0][:n] +
                [0.01] * max(0, n - 6),
                l2s=[0.0, 0.02, 0.0, 0.0, 0.05, 0.0][:n] +
                [0.0] * max(0, n - 6),
                need_clip=[True, False, True, True, True, False][:n] +
                [True] * max(0, n - 6),
                found_inf=torch.tensor(found, device=dev),
                inv_scale=torch.tensor(1 / 256.0, device=dev),
                clip_scale=torch.tensor(0.37, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("write", [False, True])
@pytest.mark.parametrize("unscale", [False, True])
def test_multi_tensor_norm_matches_plain(cuda, unscale, write):
    gen = torch.Generator(device=cuda).manual_seed(1)
    dts = (torch.float32, torch.bfloat16, torch.float16)
    grads = [(torch.randn(n, device=cuda, generator=gen) * 40).to(
        dts[i % 3]) for i, n in enumerate(MT_SIZES * 2)]
    clip = [i % 4 != 1 for i in range(len(grads))]
    inv = torch.tensor(1 / 64.0, device=cuda) if unscale else None
    runs = []
    for _ in range(2):
        gs = [g.clone() for g in grads]
        before = mt.multi_tensor_norm.launches
        stats, found = mt.multi_tensor_norm(gs, clip, inv, 1.0, write)
        assert mt.multi_tensor_norm.launches == before + 1
        runs.append((stats, found, gs))
    ref_gs = [g.clone() for g in grads]
    want, want_found = mt.multi_tensor_norm_ref(ref_gs, clip, inv, 1.0,
                                                write)
    torch.cuda.synchronize()
    (stats, found, gs), (stats2, _, gs2) = runs
    assert torch.equal(stats, stats2)
    assert abs(float(stats[0]) - float(want[0])) <= 1e-6 * float(want[0])
    assert abs(float(stats[1]) - float(want[1])) <= 1e-6 * float(want[1])
    assert bool(found) == bool(want_found) is False
    for a, b in zip(gs, ref_gs):
        assert torch.equal(a, b)
    grads[4][3] = float("nan")
    grads[7][0] = float("inf")
    _, found = mt.multi_tensor_norm(grads, clip, inv)
    assert bool(found)


@pytest.mark.gpu
@pytest.mark.parametrize("pdtype,master,mdtype,amsgrad", [
    (torch.bfloat16, True, torch.bfloat16, False),
    (torch.bfloat16, True, torch.float32, True),
    (torch.float32, False, torch.float32, False),
    (torch.float32, False, torch.float32, True),
    (torch.float32, False, torch.bfloat16, False),
    (torch.bfloat16, False, torch.bfloat16, True),
    (torch.float16, True, torch.float32, False)])
def test_multi_tensor_adam_matches_plain(cuda, pdtype, master, mdtype,
                                         amsgrad):
    """fp32 values within 4 fp32 ulps of the plain version, bf16 ones
    within 1 bf16 ulp; bit-identical on a second call; the counter
    raised once."""
    st = _adam_state(cuda, pdtype, master, mdtype, amsgrad)
    n = len(MT_SIZES)
    ref = _clone_state(st)
    kw_ref = _adam_kw(cuda, n)
    mt.multi_tensor_adam_ref(**ref, **kw_ref)
    outs = []
    for _ in range(2):
        got = _clone_state(st)
        kw = _adam_kw(cuda, n)
        before = mt.multi_tensor_adam.launches
        mt.multi_tensor_adam(**got, **kw)
        assert mt.multi_tensor_adam.launches == before + 1
        outs.append((got, kw))
    torch.cuda.synchronize()
    (got, kw), (got2, _) = outs
    assert int(kw["step"]) == int(kw_ref["step"]) == 7
    for key, ts in got.items():
        if ts is None:
            continue
        for a, b, c in zip(ts, ref[key], got2[key]):
            if a is None:
                continue
            assert torch.equal(a, c), key
            if a.dtype == torch.float16:
                torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
                continue
            bar = 4 if a.dtype == torch.float32 else 1
            assert float(_ulps(a, b, a.dtype).max()) <= bar, key


@pytest.mark.gpu
def test_multi_tensor_adam_found_inf_leaves_every_byte(cuda):
    st = _adam_state(cuda, torch.bfloat16, True, torch.bfloat16, True)
    before = _clone_state(st)
    kw = _adam_kw(cuda, len(MT_SIZES), found=True)
    mt.multi_tensor_adam(**st, **kw)
    torch.cuda.synchronize()
    assert int(kw["step"]) == 6
    for key, ts in st.items():
        for a, b in zip(ts, before[key]):
            if a is not None:
                assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                                   b.view(torch.uint8) if b.dim() else b)


@pytest.mark.gpu
def test_multi_tensor_tables_split_across_launches(cuda):
    """More tensors than one launch's table, in two dtype groups: the norm
    combines every launch's partials; the Adam launches raise the
    counter once, in the last."""
    sizes = [int(s) for s in np.random.default_rng(0).integers(
        1, 3000, mt.MAX_TENSORS + 200)]
    st = _adam_state(cuda, torch.float32, False, torch.float32, False,
                     sizes)
    half = len(sizes) // 2
    for key in ("params", "grads"):
        st[key][half:] = [t.bfloat16() for t in st[key][half:]]
    st["masters"][half:] = [p.float() for p in st["params"][half:]]
    groups = -(-half // mt.MAX_TENSORS) + -(-(len(sizes) - half)
                                          // mt.MAX_TENSORS)
    ref = _clone_state(st)
    kw_ref = _adam_kw(cuda, len(sizes))
    mt.multi_tensor_adam_ref(**ref, **kw_ref)
    kw = _adam_kw(cuda, len(sizes))
    before = mt.multi_tensor_adam.launches
    mt.multi_tensor_adam(**st, **kw)
    assert mt.multi_tensor_adam.launches - before == groups
    n_before = mt.multi_tensor_norm.launches
    stats, _ = mt.multi_tensor_norm(st["grads"], clip_norm=1.0)
    want, _ = mt.multi_tensor_norm_ref(st["grads"], clip_norm=1.0)
    assert mt.multi_tensor_norm.launches - n_before == \
        -(-len(sizes) // mt.MAX_TENSORS)
    torch.cuda.synchronize()
    assert int(kw["step"]) == 7
    assert abs(float(stats[0]) - float(want[0])) <= 1e-6 * float(want[0])
    for key in ("params", "masters", "exp_avgs", "exp_avg_sqs"):
        for a, b in zip(st[key], ref[key]):
            if a is not None:
                bar = 4 if a.dtype == torch.float32 else 1
                assert float(_ulps(a, b, a.dtype).max()) <= bar, key


def _tiny_adamw(dev, seed=0):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    gen = torch.Generator(device=dev).manual_seed(seed)
    ps = [torch.nn.Parameter(torch.randn(n, device=dev, generator=gen)
                             .to(torch.bfloat16 if i % 2 else torch.float32))
          for i, n in enumerate((300, 64, 4096, 17))]
    ps[3].need_clip = False
    opt = AdamW(learning_rate=1e-2, parameters=ps, multi_precision=True,
                moment_dtype="bfloat16", amsgrad=True,
                grad_clip=ClipGradByGlobalNorm(0.5))
    grads = [torch.randn(p.shape, device=dev, generator=gen).to(p.dtype)
             for p in ps]
    return ps, opt, grads


@pytest.mark.gpu
def test_adamw_runs_the_kernels_and_matches_the_cpu(cuda):
    """The default AdamW on CUDA tensors: one norm and one Adam launch a
    dtype group a step; 3 steps near the same steps on the CPU (the
    norms' sums run in other orders, so a clipped bf16 grad may round the
    other way: an Adam step of lr 1e-2 moves by about 1e-3 of itself)."""
    ps, opt, grads = _tiny_adamw(cuda)
    cps = [torch.nn.Parameter(p.detach().cpu()) for p in ps]
    cps[3].need_clip = False
    from paddle_tpu_torch.optimizer import AdamW
    copt = AdamW(learning_rate=1e-2, parameters=cps, multi_precision=True,
                 moment_dtype="bfloat16", amsgrad=True,
                 grad_clip=type(opt._grad_clip)(0.5))
    n0, a0 = mt.multi_tensor_norm.launches, mt.multi_tensor_adam.launches
    for _ in range(3):
        for p, cp, g in zip(ps, cps, grads):
            p.grad, cp.grad = g.clone(), g.cpu()
        opt.step()
        copt.step()
    assert mt.multi_tensor_norm.launches - n0 == 3
    assert mt.multi_tensor_adam.launches - a0 == 6   # fp32 and bf16 groups
    assert opt._step_count == copt._step_count == 3
    for p, cp in zip(ps, cps):
        m = opt._master_weights.get(p)
        got = (m if m is not None else p.detach()).cpu()
        cm = copt._master_weights.get(cp)
        want = cm if cm is not None else cp.detach()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.gpu
def test_fused_step_replays_as_a_cuda_graph(cuda):
    """``opt.step()`` (the norm and the Adam launches) captured in a CUDA
    graph and replayed twice equals two eager steps bit for bit."""
    pa_, oa, grads = _tiny_adamw(cuda)
    pb, ob, _ = _tiny_adamw(cuda)
    for p, q, g in zip(pa_, pb, grads):
        p.grad, q.grad = g.clone(), g.clone()
    # warm-up (the tables are built outside the capture), then back to the
    # initial state
    init = [p.detach().clone() for p in pb]
    ob.step()
    with torch.no_grad():
        for p, x in zip(pb, init):
            p.copy_(x)
        for p, m in ob._master_weights.items():
            m.copy_(p.detach().float())
        for store in ob._accumulators.values():
            for t in store.values():
                t.zero_()
        ob._step_count = 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        ob.step()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        oa.step()
        graph.replay()
    torch.cuda.synchronize()
    assert oa._step_count == ob._step_count == 2
    for p, q in zip(pa_, pb):
        assert torch.equal(p, q)
        if p in oa._master_weights:
            assert torch.equal(oa._master_weights[p], ob._master_weights[q])
    for name, store in oa._accumulators.items():
        for p, q in zip(pa_, pb):
            assert torch.equal(store[p], ob._accumulators[name][q])


@pytest.mark.gpu
def test_multi_tensor_refusals_raise_without_a_fallback(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(mt, "multi_tensor_norm_ref", refuse)
    monkeypatch.setattr(mt, "multi_tensor_adam_ref", refuse)
    st = _adam_state(cuda, torch.float32, False, torch.float32, False)
    kw = _adam_kw(cuda, len(MT_SIZES))
    bad = _clone_state(st)
    bad["grads"][0] = bad["grads"][0].bfloat16()
    with pytest.raises(TypeError, match="dtype"):
        mt.multi_tensor_adam(**bad, **kw)
    bad = _clone_state(st)
    bad["params"][2] = torch.randn(64, 64, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        mt.multi_tensor_adam(**bad, **kw)
    with pytest.raises(TypeError, match="int32"):
        mt.multi_tensor_adam(**st, **{**kw, "step": kw["step"].long()})
    with pytest.raises(TypeError, match="no kernel"):
        mt.multi_tensor_norm([torch.ones(3, device=cuda, dtype=torch.int32)])
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# serving and generation as CUDA graphs
# ---------------------------------------------------------------------------

def _tiny_gpt(dev):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    return GPTForCausalLM(cfg, device=dev, seed=0)


def _serve_tiny(model, dev, compiled, quant=None, burst=1, warm=False,
                **kw):
    """Six staggered requests (prompts 5-70 tokens, 8-16 new) through a
    tiny engine, after `warmup()` and zeroed paged counters with
    ``warm``; (engine, handles)."""
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, max_slots=4, max_len=128, page_size=16,
                        chunk_size=32, prefill_batch=2, kv_quant=quant,
                        decode_burst=burst, compiled=compiled, device=dev,
                        **kw)
    if warm:
        eng.warmup()
        for w, c in pa._COUNTERS:
            setattr(w, c, 0)
    rng = np.random.default_rng(0)
    handles = []
    for i, n in enumerate((5, 17, 33, 64, 9, 70)):
        prompt = rng.integers(1, 128, (n,)).astype(np.int32)
        handles.append(eng.submit(prompt, int(rng.integers(8, 17)),
                                  seed=100 + i))
        eng.step()
    eng.run()
    return eng, handles


def _pools_equal_past_page_0(a, b):
    """Every pool (and scale pool) of two caches bit-identical outside
    the trash page, whose colliding writes land in no fixed order."""
    names = ["k_layers", "v_layers"] + (["k_scales", "v_scales"]
                                        if a.quantized else [])
    return all(torch.equal(x[:, 1:], y[:, 1:])
               for n in names for x, y in zip(getattr(a, n), getattr(b, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("burst", [1, 4])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_serving_graphs_match_the_eager_loop(cuda, quant, burst):
    """The same requests through the captured graphs and the eager loop:
    greedy tokens identical, the pools bit-identical past page 0, one
    decode graph and at most one prefill graph a bucket."""
    model = _tiny_gpt(cuda)
    ge, gh = _serve_tiny(model, cuda, True, quant, burst)
    ee, eh = _serve_tiny(model, cuda, False, quant, burst)
    assert [h.output_tokens for h in gh] == [h.output_tokens for h in eh]
    assert _pools_equal_past_page_0(ge.cache, ee.cache)
    counts = ge.compile_counts()
    assert counts["decode_traces"] == counts["decode_executables"] == 1
    assert counts["prefill_traces"] == counts["prefill_executables"] <= \
        len(ge.chunk_buckets)
    assert ee.compile_counts()["decode_executables"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("burst", [1, 3])
def test_sampled_serving_graphs_match_the_eager_loop(cuda, burst):
    """Under ``do_sample`` a graph ends at the logits and the draw runs
    between replays: the streams equal the eager loop's."""
    model = _tiny_gpt(cuda)
    kw = dict(do_sample=True, top_k=20, top_p=0.9, temperature=0.8)
    _, gh = _serve_tiny(model, cuda, True, burst=burst, **kw)
    _, eh = _serve_tiny(model, cuda, False, burst=burst, **kw)
    assert [h.output_tokens for h in gh] == [h.output_tokens for h in eh]


@pytest.mark.gpu
def test_graph_replays_count_their_launches(cuda):
    """The paged kernels' counters count replays: after `warmup()` (whose
    captures follow one eager call each, with idle inputs) a run counts
    what the eager loop counts, and N more replays of the decode graph
    add N times the launches its capture recorded."""
    model = _tiny_gpt(cuda)
    runs = {}
    for compiled in (True, False):
        eng, _ = _serve_tiny(model, cuda, compiled, warm=True)
        torch.cuda.synchronize()
        runs[compiled] = pa.counters()
    assert runs[True] == runs[False]
    assert runs[True][("paged_attention", "launches_split")] > 0
    eng, _ = _serve_tiny(model, cuda, True, warm=True)
    assert eng.compile_counts()["decode_traces"] == 1
    graph = eng.decode_step._graphs.lookup(("burst", 1), eng.cache)
    assert graph.launches == {("paged_attention", "launches_split"): 2}
    before = pa.counters()
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    after = pa.counters()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {
        k: 5 * n for k, n in graph.launches.items()}


@pytest.mark.gpu
def test_recovered_engine_recaptures(cuda, monkeypatch):
    """A failed step gives the engine a fresh cache: the graphs of the
    old pools are dropped, the next step captures anew, and the tokens
    equal an undisturbed run's."""
    model = _tiny_gpt(cuda)
    _, want = _serve_tiny(model, cuda, True)
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, max_slots=4, max_len=128, page_size=16,
                        chunk_size=32, prefill_batch=2, device=cuda)
    rng = np.random.default_rng(0)
    handles = []
    for i, n in enumerate((5, 17, 33, 64, 9, 70)):
        prompt = rng.integers(1, 128, (n,)).astype(np.int32)
        handles.append(eng.submit(prompt, int(rng.integers(8, 17)),
                                  seed=100 + i))
        eng.step()
    assert eng.decode_step.trace_count == 1
    step = eng.decode_step
    monkeypatch.setattr(eng, "decode_step", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        eng.step()
    monkeypatch.setattr(eng, "decode_step", step)
    eng.run()
    assert eng.decode_step.trace_count == 2
    assert eng.decode_step.cache_size() == 1
    assert [h.output_tokens for h in handles] == \
        [h.output_tokens for h in want]


@pytest.mark.gpu
def test_set_decode_burst_recaptures(cuda):
    """`warmup()` captures every graph; `set_decode_burst(4)` builds a
    fresh decode step that captures once, with the tokens of an eager
    engine at burst 4."""
    model = _tiny_gpt(cuda)
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, max_slots=4, max_len=128, page_size=16,
                        chunk_size=32, prefill_batch=2, device=cuda)
    eng.warmup()
    counts = eng.compile_counts()
    assert counts["decode_traces"] == 1
    assert counts["prefill_traces"] == len(eng.chunk_buckets) == 3
    assert eng.warmup_report["programs"] == 4
    eng.set_decode_burst(4)
    assert eng.decode_step.trace_count == 0
    rng = np.random.default_rng(0)
    handles = []
    for i, n in enumerate((5, 17, 33, 64, 9, 70)):
        prompt = rng.integers(1, 128, (n,)).astype(np.int32)
        handles.append(eng.submit(prompt, int(rng.integers(8, 17)),
                                  seed=100 + i))
        eng.step()
    eng.run()
    _, want = _serve_tiny(model, cuda, False, burst=4)
    assert [h.output_tokens for h in handles] == \
        [h.output_tokens for h in want]
    counts = eng.compile_counts()
    assert counts["decode_traces"] == counts["decode_executables"] == 1
    assert counts["prefill_traces"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_generate_replays_its_decode_graph(cuda, quant):
    """``generate(use_cache="paged")`` decodes by replaying one graph,
    with the tokens and logits of ``compiled=False``."""
    model = _tiny_gpt(cuda)
    ids = np.random.default_rng(3).integers(1, 128, (3, 20))
    kw = dict(use_cache="paged", seq_lens=[20, 9, 14], return_logits=True,
              **({"kv_quant": quant} if quant else {}))
    out = {}
    for compiled in (True, False):
        model.__dict__.pop("_generation_engines", None)
        model.generate(ids, 6, compiled=compiled, **kw)
        out[compiled] = model.generate(ids, 12, compiled=compiled, **kw)
        eng = next(iter(model._generation_engines.values()))
        assert eng.decode_step.cache_size() == int(compiled)
    assert eng.decode_step.trace_count == 16
    model.__dict__.pop("_generation_engines", None)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


@pytest.mark.gpu
def test_guarded_per_parameter_step_copies_one_parameter_state(cuda):
    """A guarded Momentum step over about 64 M fp32 parameters holds at
    most the largest parameter's state (itself and its velocity) more
    than the unguarded step, whether it updates or skips."""
    from paddle_tpu_torch.optimizer import Momentum

    shapes = [(4096, 8192), (4096, 4096), (2048, 4096), (2048, 4096)]
    ps = [torch.nn.Parameter(torch.randn(s, device=cuda)) for s in shapes]
    opt = Momentum(learning_rate=0.1, momentum=0.9, parameters=ps)
    for p in ps:
        p.grad = torch.randn_like(p)
    opt.step()                              # the velocities exist
    largest = 2 * max(p.numel() for p in ps) * 4

    def peak_over(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    plain = peak_over(opt.step)
    guarded = peak_over(opt._guarded_step)
    ps[1].grad[7, 7] = float("inf")
    before = [p.detach().clone() for p in ps]
    skipped = peak_over(opt._guarded_step)
    assert all(torch.equal(p, b) for p, b in zip(ps, before))
    assert guarded - plain <= largest + (1 << 20), (plain, guarded)
    assert skipped - plain <= largest + (1 << 20), (plain, skipped)


@pytest.mark.gpu
@pytest.mark.parametrize("found", [False, True])
def test_multi_tensor_adam_bump_raises_the_counter_once(cuda, found):
    """Two calls over halves of one state, the first with ``bump=False``:
    the counter is read as ``step + 1`` by both and raised once, by the
    second (not at all under a set ``found_inf``); the values equal one
    call over the whole list bit for bit."""
    st = _adam_state(cuda, torch.bfloat16, True, torch.bfloat16, False)
    n = len(MT_SIZES)
    whole = _clone_state(st)
    kw = _adam_kw(cuda, n, found=found)
    mt.multi_tensor_adam(**whole, **kw)
    parts = _clone_state(st)
    kw2 = _adam_kw(cuda, n, found=found)
    h = n // 2
    before = mt.multi_tensor_adam.launches
    for sl, bump in ((slice(0, h), False), (slice(h, n), True)):
        mt.multi_tensor_adam(
            **{k: None if v is None else v[sl] for k, v in parts.items()},
            **{k: v[sl] if isinstance(v, list) else v
               for k, v in kw2.items()}, bump=bump)
    torch.cuda.synchronize()
    assert mt.multi_tensor_adam.launches - before == 2
    assert int(kw2["step"]) == int(kw["step"]) == (6 if found else 7)
    for key, ts in whole.items():
        if ts is None:
            continue
        for a, b in zip(ts, parts[key]):
            if a is not None:
                assert torch.equal(a, b), key


@pytest.mark.gpu
def test_fused_scan_step_runs_its_kernels_and_matches_the_cpu(cuda):
    """A tiny fp32 scan GPT, 3 ``FusedScanTrainStep``s (clip, fused
    head) on the card and the CPU: losses 1e-4, parameters 1e-3 relative
    (the kernels sum in other orders); one Adam launch a layer chunk plus
    one a step, the counter raised once a step; a second step builds no
    optimizer table."""
    from paddle_tpu_torch.jit import FusedScanTrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=4,
                    num_attention_heads=4, max_position_embeddings=128,
                    scan_layers=True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 128)))
    init = GPTForCausalLM(cfg, device="cpu", seed=3).state_dict()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = GPTForCausalLM(cfg, device=dev)
        model.load_state_dict(init)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = FusedScanTrainStep(model, opt, fused_head=True)
        a0 = mt.multi_tensor_adam.launches
        losses = [float(step(ids.to(dev), ids.to(dev)))]
        plans = len(mt._adam_plans)
        losses += [float(step(ids.to(dev), ids.to(dev))) for _ in range(2)]
        if dev.type == "cuda":
            assert mt.multi_tensor_adam.launches - a0 == 3 * (4 + 1)
            assert len(mt._adam_plans) == plans
        assert opt._step_count == 3
        out[dev.type] = (losses, {k: v.detach().cpu() for k, v in
                                  model.state_dict().items()})
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    assert max(abs(a - b) for a, b in zip(lg, lc)) <= 1e-4, (lg, lc)
    for k in pc:
        rel = float((pg[k] - pc[k]).abs().max() / pc[k].abs().max())
        assert rel <= 1e-3, (k, rel)


@pytest.mark.gpu
def test_fused_scan_step_builds_no_table_after_the_first(cuda, monkeypatch):
    """At GPT-3 1.3B's depth (24 layers, tiny width) a fused step hands
    the update 25 lists; every one stays cached, so the second step
    builds and uploads no table (a 16-list cache rebuilt them all)."""
    from paddle_tpu_torch.jit import FusedScanTrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    builds = []
    real = mt._launches
    monkeypatch.setattr(mt, "_launches",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    monkeypatch.setattr(mt, "_adam_plans", {})
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=24,
                    num_attention_heads=4, max_position_embeddings=128,
                    scan_layers=True)
    model = GPTForCausalLM(cfg, device=cuda, seed=0)
    step = FusedScanTrainStep(model, AdamW(parameters=model.parameters()),
                              numerics=False)
    ids = torch.zeros(2, 128, dtype=torch.long, device=cuda)
    step(ids, ids)
    assert len(builds) == 25
    step(ids, ids)
    assert len(builds) == 25


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_monitored_steps_past_the_ring_make_no_sync(cuda, fused):
    """70 steps with the numerics monitor on, past its 64-block queue,
    under ``set_sync_debug_mode("error")``: the blocks' copies to the
    host never wait for the card, and the queue folds its oldest blocks
    inside the steps once their copies have landed."""
    from paddle_tpu_torch.jit import FusedScanTrainStep, TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=128,
                    scan_layers=fused)
    model = GPTForCausalLM(cfg, device=cuda, seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    if fused:
        step = FusedScanTrainStep(model, opt, numerics=True)
        mon = step._numerics
    else:
        step = TrainStep(model, lambda m, x, y: m.loss(x, y), opt,
                         numerics=True)
        mon = step.numerics
    ids = torch.zeros(2, 128, dtype=torch.long, device=cuda)
    step(ids, ids)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _ in range(65):
            step(ids, ids)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()          # the oldest copies have landed
        torch.cuda.set_sync_debug_mode("error")
        for _ in range(4):
            step(ids, ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mon._steps_seen == 70 - 64
    s = mon.summary()
    assert s["steps_seen"] == 70 and s["finite_frac"] == 1.0


# ---------------------------------------------------------------------------
# the weight-only linear (csrc/weight_only.cu) and the dense decode graphs
# ---------------------------------------------------------------------------

# (k, n, group): aligned; K not a multiple of 16 (the scalar loads) and N
# not of the tile; grouped 128 and 64; K past one split of the decode
# route, aligned and not
WO_SHAPES = [(256, 96, -1), (200, 70, -1), (384, 100, 128), (2560, 33, 64),
             (1030, 40, -1)]
# the output's error over its largest magnitude: fp32 sums in another
# order; bf16 / fp16 one rounding of the output
WO_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float16: 8e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("m", [1, 5, 16, 17, 70])
@pytest.mark.parametrize("shape", WO_SHAPES,
                         ids=[f"k{k}_n{n}_g{g}" for k, n, g in WO_SHAPES])
def test_weight_only_linear_against_plain(cuda, dtype, m, shape):
    """The kernel (decode route for M <= 16, tiled above) against
    `weight_only_linear_ref` on the same card inputs, with a bias; a
    second call is bit-identical; the route's counter moves once."""
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.kernels import weight_only as wo

    k, n, group = shape
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    w = torch.randn(k, n, device=cuda, generator=gen)
    q, s = weight_quantize(w, group_size=group)
    x = torch.randn(m, k, device=cuda, generator=gen).to(dtype)
    b = torch.randn(n, device=cuda, generator=gen).to(dtype)
    gs = 0 if group == -1 else group
    route = "launches_" + wo.route(dtype, m, k, gs, True)
    before = getattr(wo.weight_only_linear, route)
    got = wo.weight_only_linear(x, q, b, s)
    again = wo.weight_only_linear(x, q, b, s)
    torch.cuda.synchronize()
    assert getattr(wo.weight_only_linear, route) == before + 2
    want = wo.weight_only_linear_ref(x, q, b, s)
    assert got.dtype == dtype and got.shape == (m, n)
    err = float((got.float() - want.float()).abs().max() /
                want.float().abs().max())
    assert err <= WO_TOL[dtype], err
    assert torch.equal(got, again)


def _wo_case(dev, m, k, n, algo, group, dtype, bias, seed):
    """The kernel against `weight_only_linear_ref` (`WO_TOL`),
    bit-identical on a second call, counted once a call on its route's
    counter; returns the route."""
    from paddle_tpu_torch.nn.quant import weight_quantize
    from paddle_tpu_torch.ops.kernels import weight_only as wo

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, s = weight_quantize(torch.randn(k, n, device=dev, generator=gen) * 0.02,
                           algo=algo, group_size=group)
    x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
    b = (torch.randn(n, device=dev, generator=gen) * 0.02).to(dtype) \
        if bias else None
    which = wo.route(dtype, m, k, 0 if group == -1 else group, True)
    counter = f"launches_{which}"
    before = getattr(wo.weight_only_linear, counter)
    got = wo.weight_only_linear(x, q, b, s)
    again = wo.weight_only_linear(x, q, b, s)
    torch.cuda.synchronize()
    assert getattr(wo.weight_only_linear, counter) == before + 2
    want = wo.weight_only_linear_ref(x, q, b, s)
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    err = float((got.float() - want.float()).abs().max() /
                want.float().abs().max())
    assert err <= WO_TOL[dtype], err
    assert torch.equal(got, again)
    return which


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("m", list(range(1, 17)))
def test_weight_only_mma_route_every_m(cuda, dtype, m):
    """The decode route on tensor cores at every M of its two
    instantiations (one n8 tile of x's rows up to 8, two up to 16), at
    fc1's shape of GPT-3 1.3B ([8192, 2048]: K split in three)."""
    assert _wo_case(cuda, m, 2048, 8192, "weight_only_int8", -1, dtype,
                    True, m) == "mma"


# (m, k, n, algo, group): M at the decode route's edges, the speculative
# verify (40), a chunk (64) and a prompt pass (1024); int8 and int4 per
# channel and int8 grouped 64 / 128; K a multiple of 16 but not of 64
# (208) and N not a multiple of either route's tile (100, 200)
WO_HOPPER_CASES = [
    (m, k, n, algo, group)
    for m in (1, 8, 9, 16, 17, 40, 64, 1024)
    for k, n, algo, group in ((208, 100, "weight_only_int8", -1),
                              (2048, 2048, "weight_only_int8", -1),
                              (2048, 2048, "weight_only_int4", -1),
                              (2560, 200, "weight_only_int8", 64),
                              (2048, 6144, "weight_only_int8", 128))]


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", WO_HOPPER_CASES,
                         ids=[f"m{m}_k{k}_n{n}_{a[-4:]}_g{g}"
                              for m, k, n, a, g in WO_HOPPER_CASES])
def test_weight_only_hopper_routes(cuda, case, dtype, bias):
    """The two Hopper routes (``mma`` at M <= 16, ``wgmma`` above) against
    the plain version, with and without a bias."""
    m, k, n, algo, group = case
    want = "mma" if m <= 16 else "wgmma"
    assert _wo_case(cuda, m, k, n, algo, group, dtype, bias,
                    m + k + n) == want


@pytest.mark.gpu
def test_weight_only_linear_refuses_on_the_card(cuda):
    from paddle_tpu_torch.ops.kernels import weight_only as wo

    q = torch.zeros(8, 32, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        wo.weight_only_linear(torch.zeros(2, 32, dtype=torch.int32,
                                          device=cuda), q)
    with pytest.raises(ValueError, match="on cpu"):
        wo.weight_only_linear(torch.zeros(2, 32, device=cuda), q.cpu())
    y = wo.weight_only_linear(torch.zeros(0, 32, device=cuda), q)
    assert y.shape == (0, 8)
    # the Hopper routes' own shape checks: K and the group multiples of
    # 16, a split a multiple of the pass, a token tile of 64 / 128 / 256,
    # bf16 / fp16 only; a refused launch returns an error and runs nothing
    lib = wo._lib()
    x = torch.zeros(20, 48, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(8, 48, dtype=torch.int8, device=cuda)
    y = torch.empty(20, 8, dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = (x.data_ptr(), w.data_ptr(), None, None, y.data_ptr(), None)
    for m, k, gs, ksplit, code in ((4, 40, 0, 256, 1), (4, 48, 24, 256, 1),
                                   (4, 48, 0, 128, 1), (4, 48, 0, 4096, 1),
                                   (4, 48, 0, 256, 0), (17, 48, 0, 256, 1)):
        assert lib.wo_mma(*ptr, m, 8, k, gs, ksplit, code, stream) != 0
    for m, k, gs, bn, code in ((20, 40, 0, 64, 1), (20, 48, 8, 64, 2),
                               (20, 48, 0, 96, 1), (20, 48, 0, 64, 0)):
        assert lib.wo_wgmma(*ptr, m, 8, k, gs, bn, 1, code, stream) != 0
    torch.cuda.synchronize()
    # fp32 x, a K off 16 and a misaligned x take the first design
    assert wo.route(torch.float32, 4, 48, 0, True) == "gemv"
    assert wo.route(torch.bfloat16, 20, 40, 0, True) == "tiled"
    before = wo.weight_only_linear.launches_tiled
    xm = torch.zeros(20 * 48 + 1, dtype=torch.bfloat16, device=cuda)[1:]
    wo.weight_only_linear(xm.view(20, 48), w)
    assert wo.weight_only_linear.launches_tiled == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_dense_generate_replays_its_graphs(cuda, int8):
    """``generate(use_cache="dense")`` replays one prompt graph a bucket
    and one decode graph, with the tokens and logits of
    ``compiled=False`` on the card and the greedy tokens of the CPU; the
    int8 model's graphs launch the weight-only kernel on both routes."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn.quant import quantize_for_decode
    from paddle_tpu_torch.ops.kernels import weight_only as wo

    card = _tiny_gpt(cuda)
    cpu = GPTForCausalLM(card.config, device="cpu")
    # weights of 0.3 (chip_smoke's parity phases): logits far enough apart
    # that the card's and the CPU's sums pick the same tokens
    rng = np.random.default_rng(0)
    sd = {name: torch.from_numpy(
              (rng.standard_normal(tuple(t.shape)) * 0.3).astype(np.float32))
          for name, t in cpu.state_dict().items()}
    cpu.load_state_dict(sd)
    card.load_state_dict(sd)
    if int8:
        quantize_for_decode(card)
        quantize_for_decode(cpu)
    ids = np.random.default_rng(5).integers(1, 128, (3, 20))
    out = {}
    for compiled in (True, False):
        card.__dict__.pop("_generation_engines", None)
        card.generate(ids, 4, compiled=compiled)
        wo.weight_only_linear.launches_gemv = 0
        wo.weight_only_linear.launches_tiled = 0
        out[compiled] = card.generate(ids, 12, compiled=compiled,
                                      return_logits=True)
        eng, = card._generation_engines.values()
        assert eng.decode_step.cache_size() == int(compiled)
        assert eng.prefill_step.cache_size() == int(compiled)
        if compiled:
            assert eng.decode_step.trace_count == 1
            assert eng.prefill_step.trace_count == 1
        layers = card.config.num_layers
        assert wo.weight_only_linear.launches_tiled == (4 * layers
                                                        if int8 else 0)
        assert wo.weight_only_linear.launches_gemv == (
            11 * (4 * layers) if int8 else 0)
    card.__dict__.pop("_generation_engines", None)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    want = cpu.generate(ids, 12)
    assert torch.equal(out[True][0], want)


# ---------------------------------------------------------------------------
# speculative decoding as CUDA graphs
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cache,quant,draft,sample", [
    ("dense", None, "weak", False), ("paged", None, "weak", False),
    ("paged", "int8", "self", False), ("paged", "int4", "weak", False),
    ("paged", None, "weak", True), ("dense", None, "self", True)])
def test_spec_generate_graphs_match_eager(cuda, cache, quant, draft,
                                          sample):
    """Speculative ``generate()`` through its graphs (greedy: one a
    dispatch; sampled: the draft's and the verify's) gives the tokens and
    logits of ``compiled=False`` on the card; greedy, the plain decode's
    tokens; each paged dispatch launches the draft's decode k + 1 times a
    draft layer (a self-draft: once a target layer) and the verify's
    chunk once a target layer."""
    from paddle_tpu_torch.jit import GenerationEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    k = 3
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=128,
                    num_draft_heads=k if draft == "self" else 0)
    tgt = GPTForCausalLM(cfg, device=cuda, seed=0)
    d = "self" if draft == "self" else GPTForCausalLM(
        GPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                  num_attention_heads=2, max_position_embeddings=128),
        device=cuda, seed=7)
    ids = np.random.default_rng(3).integers(1, 128, (3, 20))
    kw = dict(kind=cache, batch=3, max_len=64,
              **({"kv_quant": quant} if quant else {}),
              **(dict(do_sample=True, top_k=20) if sample else {}))
    out = {}
    for compiled in (True, False):
        eng = GenerationEngine(tgt, draft_model=d, spec_k=k,
                               compiled=compiled, **kw)
        eng.generate(ids, 5, seed=1)
        for w, c in pa._COUNTERS:
            setattr(w, c, 0)
        out[compiled] = eng.generate(ids, 17, return_logits=True, seed=2)
        if compiled:
            assert eng.spec_step.cache_size() == (1 if not sample else 2)
            disp = eng.spec_stats["dispatches"]
            if cache == "paged":
                mode = "" if quant is None else f"_{quant}"
                # the draft's decode over its own fp32 pools, or the
                # self-draft's over the target's; the verify's chunk
                dmode = mode if draft == "self" else ""
                dec = sum(getattr(pa.paged_attention, c + dmode)
                          for c in ("launches", "launches_split"))
                chunk = sum(getattr(pa.paged_attention_chunk, c + mode)
                            for c in ("launches", "launches_wgmma"))
                assert dec == disp * (cfg.num_layers if draft == "self"
                                      else k + 1)
                assert chunk == disp * cfg.num_layers
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    if not sample:
        plain = GenerationEngine(tgt, **kw).generate(ids, 17)
        assert torch.equal(out[True][0], plain)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8"])
def test_spec_serving_graphs_match_eager(cuda, quant):
    """Speculative serving through one greedy graph and the eager loop:
    identical tokens, one capture, no page leaked."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    model = _tiny_gpt(cuda)
    draft = GPTForCausalLM(GPTConfig(vocab_size=128, hidden_size=32,
                                     num_layers=1, num_attention_heads=2,
                                     max_position_embeddings=128),
                           device=cuda, seed=7)
    ge, gh = _serve_tiny(model, cuda, True, quant, draft_model=draft,
                         spec_k=3)
    ee, eh = _serve_tiny(model, cuda, False, quant, draft_model=draft,
                         spec_k=3)
    assert [h.output_tokens for h in gh] == [h.output_tokens for h in eh]
    assert ge.compile_counts()["decode_traces"] == 1
    lk = ge.leak_check()
    assert lk["free_pages"] == lk["total_pages"]
