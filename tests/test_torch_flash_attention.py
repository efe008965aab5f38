"""Flash attention of the PyTorch port against the JAX package.

The four plain versions (which CPU tensors take, and which the CUDA
kernels follow) against the reference's Pallas kernels in interpret mode:
`flash_attention_single_ref` / `_bwd_ref` against ``fa._fwd_single`` /
``fa._bwd_single`` (s 16, 64, 80 and 128: under, at and off the bf16
kernel's 128-row tiles; and s 130, 200 and 384 at head dims 16, 48, 80
and 128, the edges of the bf16 warpgroup backward), `flash_attention_ref` /
`flash_attention_bwd_ref` against ``fa._fwd`` / ``fa._bwd`` (s 256 with
64-row blocks, as tests/test_pallas.py forces the tiled path), causal and
not, fp32 and bf16; the lse against lane 0 of the reference's
lane-replicated one; the bf16 cast points of both paths; the ring
composition of the tiled entries from an outside (global) lse against
``ring_flash_attention`` on a CPU mesh; the routing of
``scaled_dot_product_attention`` under ``FLAGS_splash_attn``; the launch
counters of both routes (CPU calls move none); and, for bit-reproducible
gradients, no float atomics in the attention CUDA sources.

Inputs are numpy arrays from a seed, handed to both. Tolerances: fp32
forward 2e-5 and gradients 5e-4 (tests/test_pallas.py and
tests/test_ring_attention.py: fp32 sums in another order); the ring
forward 3e-5. In bf16 both sides round at the same points, so outputs
agree bit for bit on all but a few elements, and gradients within 2e-3
(a dS element whose fp32 value differs in its last bits may round the
other way).
"""
import importlib

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed.fleet.meta_parallel import ring_flash_attention
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import splash_attention as jsa
from paddle_tpu.utils import flags as jflags
import paddle_tpu_torch
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import splash_attention as sa

SDPA = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-3}
GRAD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-3}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SCALE = 1.0 / 32 ** 0.5


def _rand(b, s, h, d, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
            for _ in range(n)]


def _to_bh(x, dtype):
    """[b, s, h, d] numpy -> the reference kernels' [b*h, s, d]."""
    b, s, h, d = x.shape
    return jnp.asarray(np.transpose(x, (0, 2, 1, 3)).reshape(b * h, s, d),
                       JDT[dtype])


def _from_bh(x, b, h):
    bh, s, d = x.shape
    return np.array(np.transpose(np.asarray(x, np.float32).reshape(
        b, h, s, d), (0, 2, 1, 3)))


def _np(t):
    return t.float().numpy()


@pytest.fixture
def splash_off():
    saved = paddle_tpu_torch.get_flags("FLAGS_splash_attn")
    paddle_tpu_torch.set_flags({"FLAGS_splash_attn": False})
    yield
    paddle_tpu_torch.set_flags(saved)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [16, 64, 80, 128])
def test_single_block_plain_matches_jax_kernel(s, causal, dtype):
    b, h, d = 2, 2, 32
    q, k, v, do = _rand(b, s, h, d, seed=s)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    jq, jk, jv, jdo = (_to_bh(x, dtype) for x in (q, k, v, do))
    want = _from_bh(jfa._fwd_single(jq, jk, jv, SCALE, causal, True), b, h)
    got = fa.flash_attention_single_ref(tq, tk, tv, causal, SCALE)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=FWD_TOL[dtype])
    jgrads = jfa._bwd_single(jq, jk, jv, jdo, SCALE, causal, True)
    grads = fa.flash_attention_single_bwd_ref(tq, tk, tv, tdo, causal,
                                              SCALE)
    for g, w in zip(grads, jgrads):
        assert g.dtype == dtype
        np.testing.assert_allclose(_np(g), _from_bh(w, b, h), rtol=0,
                                   atol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 48, 80, 128])
@pytest.mark.parametrize("s", [130, 200, 384])
def test_single_block_plain_matches_jax_kernel_at_wgmma_edges(s, d, causal,
                                                              dtype):
    """The single-block pair's plain versions at the edges of the bf16
    warpgroup backward: lengths off its 128-row and 128-key (and 64-row)
    tiles, head dims padded to 64 and 128; the forward and the backward
    (which recomputes the softmax and its delta = sum(p * dP)) against
    the Pallas kernels in interpret mode."""
    b, h = 1, 2
    q, k, v, do = _rand(b, s, h, d, seed=s + d)
    sc = 1.0 / d ** 0.5
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    jq, jk, jv, jdo = (_to_bh(x, dtype) for x in (q, k, v, do))
    want = _from_bh(jfa._fwd_single(jq, jk, jv, sc, causal, True), b, h)
    got = fa.flash_attention_single_ref(tq, tk, tv, causal, sc)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=FWD_TOL[dtype])
    jgrads = jfa._bwd_single(jq, jk, jv, jdo, sc, causal, True)
    grads = fa.flash_attention_single_bwd_ref(tq, tk, tv, tdo, causal, sc)
    for g, w in zip(grads, jgrads):
        assert g.dtype == dtype and tuple(g.shape) == (b, s, h, d)
        np.testing.assert_allclose(_np(g), _from_bh(w, b, h), rtol=0,
                                   atol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_plain_matches_jax_kernel(causal, dtype):
    """Forward, lse (lane 0 of the reference's [b*h, s, 128]) and the
    backward from the reference forward's own out and lse."""
    b, s, h, d = 1, 256, 2, 32
    q, k, v, do = _rand(b, s, h, d, seed=7)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    jq, jk, jv, jdo = (_to_bh(x, dtype) for x in (q, k, v, do))
    jout, jlse = jfa._fwd(jq, jk, jv, SCALE, causal, 64, 64, True)
    out, lse = fa.flash_attention_ref(tq, tk, tv, causal, SCALE,
                                      return_lse=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, h, s)
    np.testing.assert_allclose(_np(out), _from_bh(jout, b, h), rtol=0,
                               atol=FWD_TOL[dtype])
    jlse = np.asarray(jlse)
    assert (jlse == jlse[..., :1]).all()            # lane-replicated
    np.testing.assert_allclose(lse.numpy(), jlse[..., 0].reshape(b, h, s),
                               rtol=0, atol=2e-5)
    jgrads = jfa._bwd(jq, jk, jv, jout, jlse, jdo, SCALE, causal, 64, 64,
                      True)
    grads = fa.flash_attention_bwd_ref(
        tq, tk, tv, torch.from_numpy(_from_bh(jout, b, h)).to(dtype),
        torch.from_numpy(jlse[..., 0].reshape(b, h, s).copy()), tdo, causal,
        SCALE)
    for g, w in zip(grads, jgrads):
        assert g.dtype == dtype
        np.testing.assert_allclose(_np(g), _from_bh(w, b, h), rtol=0,
                                   atol=GRAD_TOL[dtype])


def test_bf16_cast_points_of_both_paths():
    """The single-block path rounds P after dividing by the row sum, the
    tiled path rounds the unnormalised P of each 64-key block: in bf16
    each plain version equals its own Pallas kernel on all but a few
    elements, and the two paths differ from each other on many."""
    b, s, h, d = 1, 256, 2, 32
    q, k, v = _rand(b, s, h, d, seed=11, n=3)
    bf = torch.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(bf) for x in (q, k, v))
    jq, jk, jv = (_to_bh(x, bf) for x in (q, k, v))
    single = _np(fa.flash_attention_single_ref(tq, tk, tv, True, SCALE))
    tiled = _np(fa.flash_attention_ref(tq, tk, tv, True, SCALE))
    j_single = _from_bh(jfa._fwd_single(jq, jk, jv, SCALE, True, True), b,
                        h)
    j_tiled = _from_bh(jfa._fwd(jq, jk, jv, SCALE, True, 64, 64, True)[0],
                       b, h)
    assert (single == j_single).mean() > 0.999
    assert (tiled == j_tiled).mean() > 0.999
    assert (single != tiled).mean() > 0.05
    assert (single != j_tiled).mean() > 0.05


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,blocks", [(64, None), (256, 64)])
def test_flash_attention_autograd_matches_jax(s, blocks):
    """`flash_attention` (both autograd Functions) against the reference's
    custom_vjp in interpret mode: output and the gradients of
    sum(sin(out))."""
    b, h, d = 1, 2, 32
    q, k, v = _rand(b, s, h, d, seed=3, n=3)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jfa.flash_attention(
            q, k, v, causal=True, scale=SCALE, block_q=blocks,
            block_k=blocks, interpret=True)))

    jgrads = jax.grad(jloss, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, True, SCALE, blocks, blocks)
    torch.sin(out).sum().backward()
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                               scale=SCALE, block_q=blocks, block_k=blocks,
                               interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-5)
    for t, w in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=5e-4)


def test_path_selection_and_no_launch_on_the_cpu(monkeypatch):
    """`flash_attention` takes the single-block entries at <= 1024 tokens
    (a multiple of 16) without blocks, the tiled ones otherwise, and
    refuses a tiled length with no block; CPU tensors never count a
    launch."""
    calls = []
    for name in ("flash_attention_single_ref", "flash_attention_ref"):
        orig = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _n=name, _o=orig, **kw:
                            calls.append(_n) or _o(*a, **kw))
    launches = [getattr(fa, f).launches for f in (
        "flash_attention_fwd_single", "flash_attention_bwd_single",
        "flash_attention_fwd", "flash_attention_bwd")]
    wgmma = fa.flash_attention_fwd.launches_wgmma
    for s, blocks, want in ((48, None, "flash_attention_single_ref"),
                            (1024, None, "flash_attention_single_ref"),
                            (64, 64, "flash_attention_ref"),
                            (1280, None, "flash_attention_ref")):
        q = torch.zeros(1, s, 1, 16, requires_grad=True)
        calls.clear()
        fa.flash_attention(q, q, q, True, None, blocks, blocks).sum() \
            .backward()
        assert calls == [want], (s, blocks, calls)
    with pytest.raises(ValueError, match="unsupported seq lens"):
        fa.flash_attention(*[torch.zeros(1, 1040, 1, 16)] * 3)
    assert launches == [getattr(fa, f).launches for f in (
        "flash_attention_fwd_single", "flash_attention_bwd_single",
        "flash_attention_fwd", "flash_attention_bwd")]
    assert fa.flash_attention_fwd.launches_wgmma == wgmma


def test_backward_counters_split_by_route_and_cpu_moves_none():
    """Both backward entries count their bf16 (warpgroup) launches in
    ``.launches_wgmma`` apart from their fp32 ones in ``.launches``; CPU
    calls, which take the plain versions, move neither."""
    entries = (fa.flash_attention_fwd_single, fa.flash_attention_bwd_single,
               fa.flash_attention_fwd, fa.flash_attention_bwd)
    for f in (fa.flash_attention_bwd_single, fa.flash_attention_bwd,
              fa.flash_attention_fwd):
        assert isinstance(f.launches, int)
        assert isinstance(f.launches_wgmma, int)
    before = [(f.launches, getattr(f, "launches_wgmma", 0)) for f in entries]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(x).to(dtype)
                       for x in _rand(1, 64, 2, 16, seed=5))
        fa.flash_attention_fwd_single(q, k, v)
        fa.flash_attention_bwd_single(q, k, v, do)
        out, lse = fa.flash_attention_fwd(q, k, v)
        fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert before == [(f.launches, getattr(f, "launches_wgmma", 0))
                      for f in entries]


_CSRC = paddle_tpu_torch.__path__[0] + "/csrc"
_ATTENTION_SOURCES = ("flash_attention.cu", "splash_attention.cu",
                      "attention_tiles.cuh", "attention_wgmma.cuh",
                      "attention_wgmma_bwd.cuh", "hopper_tiles.cuh",
                      "tile_mma.cuh", "paged_attention.cu",
                      "paged_wgmma.cuh", "paged_split.cuh")


@pytest.mark.parametrize("name", _ATTENTION_SOURCES)
def test_attention_sources_use_no_float_atomics(name):
    """Bit-reproducible training gradients: no attention source adds
    floats with atomics (every sum is owned by one block, in a fixed
    order), in CUDA C++ or in inline PTX."""
    import re

    with open(f"{_CSRC}/{name}") as f:
        code = "\n".join(line.split("//")[0] for line in f)
    assert not re.search(r"\batomicAdd\w*\s*\(", code)
    ptx_float_add = r"\b(red|atom)(\.\w+)*\.add(\.\w+)*\.(f16|bf16|f32|f64)"
    assert not re.search(ptx_float_add, code)


def test_supports_follows_the_reference_gates():
    for shape, dtype in (((2, 64, 4, 64), torch.float32),
                         ((2, 1024, 4, 256), torch.bfloat16),
                         ((2, 48, 4, 64), torch.float16),
                         ((2, 2048, 4, 64), torch.bfloat16),
                         ((2, 40, 4, 64), torch.float32),
                         ((2, 1040, 4, 64), torch.float32),
                         ((2, 64, 4, 320), torch.float32),
                         ((2, 64, 4, 64), torch.float64)):
        jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                  torch.float16: jnp.float16,
                  torch.float64: jnp.float64}[dtype]
        assert fa.supports(shape, dtype, True) == \
            jfa.supports(shape, jdtype, True), shape


# ---------------------------------------------------------------------------
# ring composition from an outside lse
# ---------------------------------------------------------------------------

def _port_ring(q, k, v, cot, n, causal):
    """The reference's flash-ring schedule (ring_attention.py:144-256) on
    the port's tiled entries: device ``idx`` merges, tick by tick, the
    ``(out, lse)`` of its q block against k/v block ``src`` (causal within
    the diagonal block, full below it, skipped above), then runs the
    backward of each visited block pair from its GLOBAL out and lse."""
    b, s, h, d = q.shape
    blk = s // n
    cut = [lambda x, i=i: x[:, i * blk:(i + 1) * blk] for i in range(n)]

    def mode(idx, src):
        if not causal:
            return "full"
        return "diag" if src == idx else ("full" if src < idx else "skip")

    outs, lses = [], []
    for idx in range(n):
        out = torch.zeros(b, blk, h, d)
        lse = torch.full((b, h, blk), -1e30)
        for t in range(n):
            src = (idx - t) % n
            m = mode(idx, src)
            if m == "skip":
                continue
            ob, lb = fa.flash_attention_fwd(cut[idx](q), cut[src](k),
                                            cut[src](v), m == "diag", SCALE)
            new = torch.logaddexp(lse, lb)
            w1 = torch.exp(lse - new).transpose(1, 2)[..., None]
            w2 = torch.exp(lb - new).transpose(1, 2)[..., None]
            out, lse = out * w1 + ob.float() * w2, new
        outs.append(out.to(q.dtype))
        lses.append(lse)
    dq = [torch.zeros(b, blk, h, d) for _ in range(n)]
    dk = [torch.zeros(b, blk, h, d) for _ in range(n)]
    dv = [torch.zeros(b, blk, h, d) for _ in range(n)]
    for idx in range(n):
        for src in range(n):
            m = mode(idx, src)
            if m == "skip":
                continue
            g = fa.flash_attention_bwd(cut[idx](q), cut[src](k), cut[src](v),
                                       outs[idx], lses[idx], cut[idx](cot),
                                       m == "diag", SCALE)
            dq[idx] += g[0].float()
            dk[src] += g[1].float()
            dv[src] += g[2].float()
    return [torch.cat(x, 1) for x in (outs, dq, dk, dv)]


@pytest.mark.parametrize("n,causal", [(2, True), (4, True), (2, False)])
def test_ring_composition_matches_ring_flash_attention(n, causal):
    """The contract ring attention needs from the tiled pair: `_fwd`
    returns (out, lse), and `_bwd` takes an outside lse and out, with no
    renormalisation, so blockwise gradients sum to the global ones."""
    b, s, h, d = 1, 128 * n, 2, 32
    q, k, v, cot = _rand(b, s, h, d, seed=n)
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("sep",))

    def jf(q, k, v):
        return ring_flash_attention(q, k, v, mesh=mesh, axis="sep",
                                    causal=causal, scale=SCALE)

    jout, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(cot))
    got = _port_ring(*map(torch.from_numpy, (q, k, v, cot)), n, causal)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jout), rtol=0,
                               atol=3e-5)
    for g, w in zip(got[1:], jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=5e-4)


# ---------------------------------------------------------------------------
# scaled_dot_product_attention's routing under FLAGS_splash_attn
# ---------------------------------------------------------------------------

def _spy_routes(monkeypatch):
    seen = []

    def spy(name):
        def f(q, *a, **kw):
            seen.append(name)
            return torch.zeros_like(q)
        return f

    monkeypatch.setattr(sa, "splash_attention", spy("splash"))
    monkeypatch.setattr(fa, "flash_attention", spy("flash"))
    monkeypatch.setattr(SDPA, "_sdpa_ref", spy("dense"))
    return seen


def _route(seen, s=64, h=2, kvh=2, d=16, **kw):
    q = torch.zeros(1, s, h, d)
    kv = torch.zeros(1, s, kvh, d)
    seen.clear()
    PF.scaled_dot_product_attention(q, kv, kv, **kw)
    return seen[0]


@pytest.fixture
def routing_flags():
    """Restores the port's two routing flags after a test."""
    names = ["FLAGS_splash_attn", "FLAGS_pallas_flash_min_seqlen"]
    saved = paddle_tpu_torch.get_flags(names)
    yield
    paddle_tpu_torch.set_flags(saved)


def test_sdpa_routes_by_the_flag(monkeypatch, routing_flags):
    """The reference's routing: segment ids go to splash at any length
    (flag on, no dropout); otherwise a kernel runs only at ``seqlen >=
    FLAGS_pallas_flash_min_seqlen`` with no mask and no active dropout,
    where its gate takes the shape (splash: lengths a multiple of 128;
    flash: a multiple of 16 up to 1024, of 128 above); the rest is the
    dense attention."""
    seen = _spy_routes(monkeypatch)
    seg = torch.zeros(1, 64, dtype=torch.int32)
    mask = torch.ones(1, 1, 1024, 1024, dtype=torch.bool)
    assert paddle_tpu_torch.get_flags("FLAGS_pallas_flash_min_seqlen") == \
        {"FLAGS_pallas_flash_min_seqlen": 1024}
    paddle_tpu_torch.set_flags({"FLAGS_splash_attn": True})
    assert _route(seen, segment_ids=seg) == "splash"
    assert _route(seen, segment_ids=seg, dropout_p=0.1) == "dense"
    assert _route(seen, is_causal=True) == "dense"        # 64 < 1024
    assert _route(seen, s=1024, is_causal=True) == "splash"
    assert _route(seen, s=1024, kvh=1) == "splash"        # GQA
    assert _route(seen, s=1100) == "dense"                # no block
    assert _route(seen, s=1024, d=320) == "dense"
    assert _route(seen, s=1024, attn_mask=mask) == "dense"
    assert _route(seen, s=1024, dropout_p=0.1) == "dense"
    assert _route(seen, s=1024, dropout_p=0.1, training=False) == "splash"
    paddle_tpu_torch.set_flags({"FLAGS_pallas_flash_min_seqlen": 16})
    assert _route(seen, s=128, is_causal=True) == "splash"
    assert _route(seen, is_causal=True) == "flash"        # splash: % 128
    assert _route(seen, s=40) == "dense"                  # neither gate
    paddle_tpu_torch.set_flags({"FLAGS_splash_attn": False,
                                "FLAGS_pallas_flash_min_seqlen": 1024})
    assert paddle_tpu_torch.get_flags(["FLAGS_splash_attn"]) == \
        {"FLAGS_splash_attn": False}
    assert _route(seen, is_causal=True) == "dense"
    assert _route(seen, s=1024, is_causal=True) == "flash"
    assert _route(seen, s=2048) == "flash"
    assert _route(seen, s=1024, dropout_p=0.1, training=False) == "flash"
    assert _route(seen, segment_ids=seg) == "dense"
    assert _route(seen, s=1040) == "dense"                # tiled: % 128
    assert _route(seen, s=1024, kvh=1) == "dense"         # GQA: shapes differ
    assert _route(seen, s=1024, d=320) == "dense"
    assert _route(seen, s=1024, attn_mask=mask) == "dense"
    assert _route(seen, s=1024, dropout_p=0.1) == "dense"
    paddle_tpu_torch.set_flags({"FLAGS_pallas_flash_min_seqlen": 16})
    assert _route(seen, is_causal=True) == "flash"
    assert _route(seen, s=40) == "dense"          # not a multiple of 16


def test_sdpa_refusals_off_the_cpu(splash_off):
    """Off the CPU, a mask, active dropout and the dense segment mask run
    the dense attention, as the reference runs its XLA ``_sdpa_ref`` on
    its accelerator (``meta`` tensors stand in for a device: the output
    has the query's shape and device); so does the dense attention
    without them; a shape flash takes goes to its wrapper, which has no
    kernel for ``meta`` tensors and refuses them."""
    q = torch.zeros(1, 64, 2, 16, device="meta")
    seg = torch.zeros(1, 64, dtype=torch.int32, device="meta")
    for kw in ({"segment_ids": seg}, {"dropout_p": 0.1},
               {"attn_mask": torch.ones(1, 1, 64, 64, dtype=torch.bool,
                                        device="meta")}):
        out = PF.scaled_dot_product_attention(q, q, q, **kw)
        assert out.device.type == "meta" and out.shape == q.shape, kw
    for s in (40, 64, 1040):
        x = torch.zeros(1, s, 2, 16, device="meta")
        out = PF.scaled_dot_product_attention(x, x, x, is_causal=True)
        assert out.device.type == "meta" and out.shape == x.shape
    q1k = torch.zeros(1, 1024, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        PF.scaled_dot_product_attention(q1k, q1k, q1k, is_causal=True)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_and_flash_functionals_match_jax_with_splash_off(
        causal, routing_flags):
    """The reference routes to its Pallas flash kernel with the splash
    flag off (``FLAGS_pallas_flash_min_seqlen`` lowered in both packages
    so that 64 tokens qualify); the port to its flash entries.
    ``flash_attention`` and ``flash_attn_qkvpacked`` agree with theirs."""
    paddle_tpu_torch.set_flags({"FLAGS_splash_attn": False,
                                "FLAGS_pallas_flash_min_seqlen": 16})
    q, k, v = _rand(2, 64, 2, 32, seed=5, n=3)
    saved = {n: jflags.get_flag(n) for n in (
        "FLAGS_splash_attn", "FLAGS_pallas_flash_min_seqlen")}
    jflags.set_flags({"FLAGS_splash_attn": False,
                      "FLAGS_pallas_flash_min_seqlen": 16})
    try:
        jq, jk, jv = map(paddle.to_tensor, (q, k, v))
        want = JF.scaled_dot_product_attention(jq, jk, jv, is_causal=causal)
        jflash, _ = JF.flash_attention(jq, jk, jv, causal=causal)
        jpacked, _ = JF.flash_attn_qkvpacked(
            paddle.to_tensor(np.stack([q, k, v], 2)), causal=causal)
    finally:
        jflags.set_flags(saved)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = PF.scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    flash, none = PF.flash_attention(tq, tk, tv, causal=causal)
    packed, _ = PF.flash_attn_qkvpacked(torch.stack([tq, tk, tv], 2),
                                        causal=causal)
    assert none is None
    for g, w in ((got, want), (flash, jflash), (packed, jpacked)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5)


def test_sdpa_ref_stores_bf16_scores_as_the_reference(splash_off):
    """The dense path (here: an attn_mask) rounds bf16 scores to bf16
    before the fp32 softmax, as the reference's ``_sdpa_ref`` does by
    default: the outputs agree bit for bit (with fp32 scores, about a
    fifth of them would differ)."""
    q, k, v = _rand(1, 32, 2, 16, seed=6, n=3)
    mask = np.random.default_rng(6).random((1, 1, 32, 32)) > 0.3
    mask[..., 0] = True
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(x).astype("bfloat16") for x in (q, k, v)),
        attn_mask=paddle.to_tensor(mask), is_causal=True)
    got = PF.scaled_dot_product_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want._data.astype(jnp.float32)))


def _bf16_ulp(x):
    """One bf16 unit in the last place at each element of ``x``."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("splash", [True, False])
@pytest.mark.parametrize("s", [128, 1100])
def test_sdpa_below_the_gates_matches_the_reference_in_bf16(
        monkeypatch, routing_flags, s, splash):
    """With default flags, below ``FLAGS_pallas_flash_min_seqlen`` (128
    tokens) and where the kernels' block gates refuse the length (1100: no
    multiple of 128), both packages run the dense attention, whose bf16
    scores are stored in bf16 before the fp32 softmax. The bf16 outputs
    agree bit for bit except where XLA's fp32 dot sums in another order
    than PyTorch's and a score on a bf16 rounding boundary rounds apart:
    such an element moves by a share of the row's values, within one bf16
    ulp of the row's largest magnitude. The splash kernel that ran here
    before keeps fp32 scores: its plain version rounds a third of the
    elements otherwise."""
    b, h, d = 1, 2, 32
    q, k, v = _rand(b, s, h, d, seed=s, n=3)
    jsaved = jflags.get_flags(["FLAGS_splash_attn",
                               "FLAGS_pallas_flash_min_seqlen"])
    assert jsaved["FLAGS_pallas_flash_min_seqlen"] == 1024
    assert paddle_tpu_torch.get_flags("FLAGS_pallas_flash_min_seqlen") == \
        {"FLAGS_pallas_flash_min_seqlen": 1024}
    jflags.set_flags({"FLAGS_splash_attn": splash})
    try:
        want = JF.scaled_dot_product_attention(
            *(paddle.to_tensor(x).astype("bfloat16") for x in (q, k, v)),
            is_causal=True)
    finally:
        jflags.set_flags(jsaved)
    want = np.asarray(want._data.astype(jnp.float32))
    paddle_tpu_torch.set_flags({"FLAGS_splash_attn": splash})
    dense = []
    orig = SDPA._sdpa_ref
    monkeypatch.setattr(SDPA, "_sdpa_ref", lambda *a: dense.append(1) or
                        orig(*a))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = PF.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    assert dense == [1] and got.dtype == torch.bfloat16
    got = got.float().numpy()
    row_ulp = _bf16_ulp(np.abs(want).max(-1, keepdims=True))
    assert (got == want).mean() > 0.999
    assert (np.abs(got - want) <= row_ulp).all()
    before = _np(sa.splash_attention_ref(tq, tk, tv, True))
    assert (before == want).mean() < 0.9


@pytest.mark.parametrize("b,s,h,d,causal", [
    (1, 130, 2, 32, False), (2, 208, 3, 80, True), (1, 256, 2, 128, True)])
def test_tiled_plain_matches_jax_at_the_card_check_shapes(b, s, h, d,
                                                          causal):
    """The tiled pair's plain versions at the ragged shapes chip_smoke.py
    phase 3 holds the bf16 forward on warpgroup products to (lengths off
    its 128-row items, head dims padded to 64 and 128), fp32: against
    ``fa._fwd`` / ``fa._bwd`` in interpret mode where 64-row blocks divide
    the length (out, lse and the backward from the reference's own out
    and lse), else against autograd of the reference's dense
    `splash_attention_xla` (kvh = nh, no segments: the same function)."""
    q, k, v, do = _rand(b, s, h, d, seed=s + d)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa.flash_attention_ref(tq, tk, tv, causal, SCALE,
                                      return_lse=True)
    if s % 64 == 0:
        jq, jk, jv, jdo = (_to_bh(x, torch.float32) for x in (q, k, v, do))
        jout, jlse = jfa._fwd(jq, jk, jv, SCALE, causal, 64, 64, True)
        jlse = np.asarray(jlse)
        np.testing.assert_allclose(lse.numpy(),
                                   jlse[..., 0].reshape(b, h, s), rtol=0,
                                   atol=2e-5)
        jgrads = [_from_bh(g, b, h) for g in jfa._bwd(
            jq, jk, jv, jout, jlse, jdo, SCALE, causal, 64, 64, True)]
        jout = _from_bh(jout, b, h)
        grads = fa.flash_attention_bwd_ref(
            tq, tk, tv, torch.from_numpy(jout),
            torch.from_numpy(jlse[..., 0].reshape(b, h, s).copy()), tdo,
            causal, SCALE)
    else:
        jout, vjp = jax.vjp(
            lambda q, k, v: jsa.splash_attention_xla(
                q, k, v, causal=causal, scale=SCALE),
            *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(do))
        grads = fa.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                           causal, SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=FWD_TOL[torch.float32])
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=GRAD_TOL[torch.float32])
