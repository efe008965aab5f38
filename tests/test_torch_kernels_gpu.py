"""The port's CUDA paged-attention kernels against their plain versions.

These run only on a CUDA card (marker ``gpu``; each test skips without
one). The file imports torch, numpy and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 1e-4 (fp32 accumulation in another order than the
plain version's matmuls), bf16 2e-2 (the output's bf16 rounding, against
the plain version on the same bf16 inputs).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import paged_attention as pa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def _check(kernel, plain, args, q_dtype, kv_dtype):
    q, k, v, pt, pos = args
    args = (q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype), pt, pos)
    n = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
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
    _check(pa.paged_attention_chunk, pa.paged_attention_chunk_ref,
           (q, k, v, pt, start), q_dtype, kv_dtype)


@pytest.mark.gpu
def test_decode_is_the_chunk_of_one(cuda):
    q, k, v, pt = _inputs(cuda, 4, 8, 2, 64, 16, 4)
    lens = torch.tensor([3, 16, 17, 64], dtype=torch.int32, device=cuda)
    dec = pa.paged_attention(q, k, v, pt, lens)
    chunk = pa.paged_attention_chunk(q[:, None].contiguous(), k, v, pt,
                                     lens - 1)
    torch.cuda.synchronize()
    assert torch.equal(dec, chunk[:, 0])


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
