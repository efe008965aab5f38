"""Splash training attention of the PyTorch port against the JAX package.

The port's plain version (`splash_attention_ref`) and its autograd
wrapper on CPU tensors (the plain forward, then `splash_attention_bwd_ref`
from the lse, as the backward kernels compute it) are held against the
reference's `splash_attention` in interpret mode (the Pallas kernel's own
CPU route) and the gradients of its custom_vjp, over the grid of the
reference's tests: causal and plain, GQA and not, with and without
packed-sequence segment ids, s 128 and 256. Inputs are numpy arrays from
a seed, handed to both. Tolerance: atol 1e-5 in fp32 (fp32 scores and
sums on both sides, in another order).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas import splash_attention as jsa
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.kernels import splash_attention as sa

ATOL = 1e-5


def _rand(b, s, h, kvh, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    q = (rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, sk, kvh, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, sk, kvh, d)) * 0.5).astype(np.float32)
    return q, k, v


def _segments(b, s, docs, seed=0):
    """[b, s] int32: ``docs`` documents a row at random cuts, the last
    row a single document."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(b):
        n = 1 if i == b - 1 else docs
        cuts = np.sort(rng.choice(np.arange(1, s), n - 1, replace=False))
        rows.append(np.searchsorted(cuts, np.arange(s), side="right"))
    return np.stack(rows).astype(np.int32)


def _port(q, k, v, causal, seg, cot):
    """Port output and dq/dk/dv of sum(out * cot) on CPU tensors."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ts = None if seg is None else torch.from_numpy(seg)
    out = sa.splash_attention(tq, tk, tv, causal=causal, segment_ids=ts)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), \
        tv.grad.numpy()


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("h,kvh", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_jax_kernel(causal, h, kvh, segments, s):
    b, d = 2, 32
    q, k, v = _rand(b, s, h, kvh, d, seed=s + h)
    seg = _segments(b, s, 3, seed=s) if segments else None
    cot = np.random.default_rng(9).standard_normal((b, s, h, d)) \
        .astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)

    def jf(q, k, v):
        return jsa.splash_attention(q, k, v, causal=causal,
                                    segment_ids=jseg, interpret=True)

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(cot))
    got = _port(q, k, v, causal, seg, cot)
    np.testing.assert_allclose(got[0], np.asarray(jout), rtol=0, atol=ATOL)
    for g, want in zip(got[1:], jgrads):
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_xla_fallback(causal):
    """`splash_attention_ref` is a transcription of the reference's
    `splash_attention_xla`: GQA with segments, fp32."""
    q, k, v = _rand(2, 96, 4, 1, 16, seed=2)
    seg = _segments(2, 96, 4, seed=2)
    want = jsa.splash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    segment_ids=jnp.asarray(seg))
    got = sa.splash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal,
                                  torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("causal,segments", [(True, False), (True, True),
                                             (False, True)])
def test_bwd_ref_equals_autograd_of_the_plain_forward(causal, segments):
    """The lse-based backward (the kernels' arithmetic) equals autograd
    through the dense plain forward."""
    b, s, h, kvh, d = 2, 80, 4, 2, 16
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _rand(b, s, h, kvh, d, seed=3))
    seg = torch.from_numpy(_segments(b, s, 3, seed=3)) if segments \
        else None
    dout = torch.randn(b, s, h, d, generator=torch.Generator()
                       .manual_seed(0))
    out, lse = sa.splash_attention_ref(q, k, v, causal, seg,
                                       return_lse=True)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = sa.splash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      out.detach(), lse.detach(), dout,
                                      causal, seg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL)


def test_empty_rows_give_zero_output_and_zero_gradients():
    """Non-causal, sk < sq, under segments: queries of a document with no
    key get zero output, lse +inf and zero gradients, never NaN; the
    reference's XLA fallback gives the same."""
    b, sq, sk, h, d = 1, 48, 32, 2, 16
    q, k, v = _rand(b, sq, h, h, d, seed=4, sk=sk)
    seg = np.array([[0] * 32 + [1] * 16], np.int32)
    cot = np.ones((b, sq, h, d), np.float32)
    out, dq, dk, dv = _port(q, k, v, False, seg, cot)
    assert np.all(out[:, 32:] == 0.0) and np.all(dq[:, 32:] == 0.0)
    assert all(np.isfinite(t).all() for t in (out, dq, dk, dv))
    _, lse = sa.splash_attention_ref(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), False,
                                     torch.from_numpy(seg), return_lse=True)
    assert torch.isinf(lse[..., 32:]).all()
    assert torch.isfinite(lse[..., :32]).all()

    def jf(q, k, v):
        return jsa.splash_attention_xla(q, k, v, causal=False,
                                        segment_ids=jnp.asarray(seg))

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out, np.asarray(jout), rtol=0, atol=ATOL)
    for g, want in zip((dq, dk, dv), jgrads):
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=ATOL)


def test_sdpa_routes_segments_to_splash_and_matches_jax():
    """`F.scaled_dot_product_attention` with segment ids (the model's
    call) against the reference's functional on the same inputs."""
    q, k, v = _rand(2, 64, 4, 4, 16, seed=5)
    seg = _segments(2, 64, 2, seed=5)
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=True, segment_ids=paddle.to_tensor(seg))
    got = PF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_sdpa_attn_mask_on_the_cpu_matches_jax():
    """An attn_mask has no kernel: on CPU tensors the plain dense
    attention runs, equal to the reference's."""
    q, k, v = _rand(1, 32, 2, 2, 16, seed=6)
    mask = np.random.default_rng(6).random((1, 1, 32, 32)) > 0.3
    mask[..., 0] = True
    want = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask))
    got = PF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_attn_mask_with_segment_ids_raises():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="not combinable"):
        PF.scaled_dot_product_attention(
            q, q, q, attn_mask=torch.ones(1, 1, 8, 8, dtype=torch.bool),
            segment_ids=torch.zeros(1, 8, dtype=torch.int32))


def test_mask_or_dropout_on_the_card_raises():
    """Off the CPU, attention with an attn_mask or active dropout takes
    the dense path, as the reference's XLA ``_sdpa_ref`` on its
    accelerator, not splash (``meta`` tensors stand in for a device: the
    output has the query's shape and device, and no kernel wrapper is
    reached, which would refuse them)."""
    q = torch.zeros(1, 8, 2, 16, device="meta")
    for kw in ({"dropout_p": 0.1},
               {"attn_mask": torch.ones(1, 1, 8, 8, dtype=torch.bool,
                                        device="meta")}):
        out = PF.scaled_dot_product_attention(q, q, q, **kw)
        assert out.device.type == "meta" and out.shape == q.shape, kw
    # dropout outside training is no dropout: at 1024 tokens the splash
    # wrapper takes it, and refuses a device it has no kernel for
    q1k = torch.zeros(1, 1024, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        PF.scaled_dot_product_attention(q1k, q1k, q1k, dropout_p=0.1,
                                        training=False)


def test_wrapper_counts_no_launch_on_the_cpu():
    """CPU tensors take the plain versions: the launch counters stay."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _rand(1, 32, 2, 2, 16, seed=7))
    def counts():
        return (sa.splash_attention_fwd.launches,
                sa.splash_attention_fwd.launches_wgmma,
                sa.splash_attention_bwd.launches,
                sa.splash_attention_bwd.launches_wgmma)

    before = counts()
    sa.splash_attention(q, k, v).sum().backward()
    qb, kb, vb = (t.detach().bfloat16().requires_grad_() for t in (q, k, v))
    sa.splash_attention(qb, kb, vb).float().sum().backward()
    assert counts() == before


# The shapes chip_smoke.py phase 3 adds for the bf16 forward on warpgroup
# products (its 128-row items and 128-key tiles): ragged lengths, head
# dims padded to 64 and 128, GQA, a key tile fully masked for some rows
# (rows 300-383 see none of keys 0-255) and rows with no visible key
# (non-causal, sk < sq: the third document's rows). (b, s, h, kvh, d,
# causal, segment ids, sk); segment ids: an int for that many documents a
# row at random cuts, a tuple for those document lengths in every row.
CARD_SHAPES = [
    (2, 200, 8, 2, 64, True, 3, None),
    (1, 130, 4, 4, 16, True, None, None),
    (2, 208, 4, 4, 80, False, None, None),
    (1, 384, 4, 2, 128, True, 3, None),
    (1, 384, 4, 2, 64, True, (130, 170, 84), None),
    (1, 300, 4, 2, 64, False, (120, 80, 100), 200),
]


@pytest.mark.parametrize("b,s,h,kvh,d,causal,docs,sk", CARD_SHAPES)
def test_plain_version_matches_jax_at_the_card_check_shapes(
        b, s, h, kvh, d, causal, docs, sk):
    """The port's splash (its plain forward and the lse-based backward
    on CPU tensors) against the reference's `splash_attention` in
    interpret mode where its gate takes the shape (lengths a multiple of
    128), else its `splash_attention_xla`: the chain kernel -> plain ->
    reference at the shapes the card check holds the kernel to."""
    q, k, v = _rand(b, s, h, kvh, d, seed=s + d, sk=sk)
    if isinstance(docs, tuple):
        seg = np.tile(np.repeat(np.arange(len(docs)), docs),
                      (b, 1)).astype(np.int32)
    else:
        seg = None if docs is None else _segments(b, s, docs, seed=s)
    cot = np.random.default_rng(d).standard_normal((b, s, h, d)) \
        .astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)
    kernel = jsa.supports((b, s, h, d), kvh, jnp.float32, sk or s)

    def jf(q, k, v):
        if kernel:
            return jsa.splash_attention(q, k, v, causal=causal,
                                        segment_ids=jseg, interpret=True)
        return jsa.splash_attention_xla(q, k, v, causal=causal,
                                        segment_ids=jseg)

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(cot))
    got = _port(q, k, v, causal, seg, cot)
    np.testing.assert_allclose(got[0], np.asarray(jout), rtol=0, atol=ATOL)
    for g, want in zip(got[1:], jgrads):
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=ATOL)
    if sk is not None:                     # the rows with no visible key
        assert np.all(got[0][:, sum(docs[:-1]):] == 0.0)
