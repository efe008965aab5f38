"""The port's zero-bubble ring, in 2 and 4 gloo ranks on the CPU, against
the JAX package's on a CPU mesh of the same size.

The ranks run `pipeline_selftest`'s ``zero_bubble`` case (no jax), one
launch a world (pp 2, pp 4), while this process computes the reference:

* `zb_linear_pipeline` on the rank's stage of ``W`` [n, d, d] against
  the reference's `zb_linear_pipeline`: outputs within 1e-5, the grads of
  the rank's stage and of the input within 1e-4 (the reference's bars,
  tests/test_pipeline.py:294-325);
* `pipeline_spmd_zb` over `GPTForCausalLMPipe`'s block body (the
  reference's weights carried by `convert.pipe_stage_from_jax`) against
  the reference's `pipeline_spmd_zb` over its block body: outputs 1e-5,
  grads 2e-4; ``dw_chunk`` 1, 3 and 4 (4 micro-batches: four chunks, a
  chunk of 3 and one of 1, one chunk) within 1e-5 of each other;
* `GPTForCausalLMPipe(use_zero_bubble=True)`: loss within 1e-5 and grads
  within 2e-4 of the reference's zero-bubble model (tests/
  test_pipeline.py:511-557), and in fp32 within 1e-5 / 2e-5 of the
  port's own AD ring on the same weights;
* the refusals, in the reference's words (``num_chunks`` 2, dropout);
* no weight grad in the ring: a tanh-linear stage whose product records
  each backward call shows the zero-bubble ring's ticks asking for the
  input's cotangent alone (``n_micro`` calls without the weight), then
  the fold asking for the weight (``n_micro`` calls), no leaf holding a
  ``.grad`` meanwhile; the AD ring's ticks ask for both.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel.spmd_pipeline import (
    pipeline_spmd_zb as jpipe_zb, zb_linear_pipeline as jzb_linear)
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLMPipe as JGPTPipe
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.pipeline_selftest import start

D, M, MB = 16, 4, 3
SEQ = 8
DW_CHUNKS = (1, 3, 4)
GPT = dict(vocab_size=64, hidden_size=32, num_layers=4,
           num_attention_heads=2, max_position_embeddings=16,
           hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
MICRO = 2


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("pp",))


def _jpipe(n, zb=False):
    return JGPTPipe(JConfig(**GPT), num_stages=n, num_micro=MICRO,
                    mesh=_mesh(n), use_zero_bubble=zb)


def _args(n):
    rng = np.random.default_rng(10 + n)
    named = {}
    for name, p in _jpipe(n).named_parameters():
        w = rng.standard_normal(np.shape(p._data)).astype(np.float32)
        named[name] = (w * 0.05 if name.endswith("bias") else
                       1.0 + 0.1 * w if "ln" in name else w * 0.1)
    return {"lin_w": (rng.standard_normal((n, D, D)) * 0.3
                      ).astype(np.float32),
            "lin_x": rng.standard_normal((M, MB, D)).astype(np.float32),
            "config": GPT, "named": named, "micro": MICRO,
            "dw_chunks": list(DW_CHUNKS),
            "block_x": rng.standard_normal(
                (M, 2, SEQ, GPT["hidden_size"])).astype(np.float32),
            "ids": rng.integers(0, GPT["vocab_size"], (4, SEQ)),
            "labels": rng.integers(0, GPT["vocab_size"], (4, SEQ))}


def _reference(n, a):
    mesh = _mesh(n)
    ref = {}
    w, x = jnp.asarray(a["lin_w"]), jnp.asarray(a["lin_x"])
    ref["lin"] = (jzb_linear(w, x, mesh=mesh), *jax.grad(
        lambda w, x: jnp.sum(jnp.sin(jzb_linear(w, x, mesh=mesh))),
        (0, 1))(w, x))
    pipe = _jpipe(n)
    for name, p in pipe.named_parameters():
        p._data = jnp.asarray(a["named"][name])
    flats = [f for f, _ in pipe._stacked_names]
    stacked = [pipe._parameters[f]._data for f in flats]
    block_fn = pipe._block_fn()
    bx = jnp.asarray(a["block_x"])

    def blocks(st, xx):
        return jpipe_zb(block_fn, st, xx, mesh=mesh)

    gst, gx = jax.grad(lambda st, xx: jnp.sum(jnp.sin(blocks(st, xx))),
                       (0, 1))(stacked, bx)
    ref["block"] = (blocks(stacked, bx), dict(zip(flats, gst)), gx)
    pipe = _jpipe(n, zb=True)
    for name, p in pipe.named_parameters():
        p._data = jnp.asarray(a["named"][name])
    ids, labels = (paddle.to_tensor(a[k], dtype="int64")
                   for k in ("ids", "labels"))
    loss = JCrit()(pipe(ids), labels)
    loss.backward()
    ref["gpt"] = (float(loss), {name: np.asarray(p.grad._data)
                                for name, p in pipe.named_parameters()})
    return {k: jax.tree.map(np.asarray, v) for k, v in ref.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["pp2", "pp4"])
def world(request):
    n = request.param
    a = _args(n)
    job = start("zero_bubble", n, a, timeout=60)
    try:        # the reference, while the ranks run
        ref = _reference(n, a)
    finally:
        outs = job.wait(deadline=200)
    return n, sorted(outs, key=lambda o: o["stage"]), ref


def _joined(outs, pick):
    return convert.pipe_stage_to_jax(
        [{k: torch.from_numpy(v) for k, v in pick(o).items()}
         for o in outs], None)


def test_zb_linear_pipeline_against_the_reference(world):
    n, outs, ref = world
    out, gW, gx = ref["lin"]
    for o in outs:
        y, w_grad, x_grad = o["lin"]
        np.testing.assert_allclose(y, out, atol=1e-5)
        np.testing.assert_allclose(w_grad, gW[o["stage"]], atol=1e-4)
        np.testing.assert_allclose(x_grad, gx, atol=1e-4)


@pytest.mark.parametrize("chunk", DW_CHUNKS)
def test_pipeline_spmd_zb_over_the_gpt_block(world, chunk):
    n, outs, ref = world
    want_y, want_g, want_dx = ref["block"]
    for o in outs:
        got = o[f"block_{chunk}"]
        np.testing.assert_allclose(got["out"], want_y, atol=1e-5)
        np.testing.assert_allclose(got["dx"], want_dx, atol=2e-4)
    joined = _joined(outs, lambda o: o[f"block_{chunk}"]["grads"])
    assert set(joined) == set(want_g)
    for k, want in want_g.items():
        np.testing.assert_allclose(joined[k], want, atol=2e-4, err_msg=k)


def test_dw_chunks_agree(world):
    n, outs, _ = world
    for o in outs:
        base = o[f"block_{DW_CHUNKS[-1]}"]
        for c in DW_CHUNKS[:-1]:
            got = o[f"block_{c}"]
            np.testing.assert_array_equal(got["out"], base["out"])
            for k, g in got["grads"].items():
                np.testing.assert_allclose(g, base["grads"][k], atol=1e-5,
                                           err_msg=(c, k))


def test_gpt_pipe_zero_bubble_against_the_reference(world):
    n, outs, ref = world
    want_loss, want_grads = ref["gpt"]
    for o in outs:
        assert abs(o["gpt_zb"]["loss"] - want_loss) < 1e-5
    joined = _joined(outs, lambda o: o["gpt_zb"]["grads"])
    assert set(joined) == set(want_grads)
    for k, want in want_grads.items():
        np.testing.assert_allclose(joined[k], want, atol=2e-4, err_msg=k)


def test_gpt_pipe_zero_bubble_against_the_ad_ring(world):
    """fp32: the same weights through both rings; the fold sums the
    micro-batches' grads in fp32, the AD ring in the parameter's dtype
    (here both fp32)."""
    n, outs, _ = world
    for o in outs:
        zb, ad = o["gpt_zb"], o["gpt_ad"]
        assert abs(zb["loss"] - ad["loss"]) < 1e-5
        assert set(zb["grads"]) == set(ad["grads"])
        for k, g in zb["grads"].items():
            np.testing.assert_allclose(g, ad["grads"][k], atol=2e-5,
                                       err_msg=k)


def test_refusals_in_the_reference_words(world):
    n, outs, _ = world
    for o in outs:
        assert o["refused"]["chunks"] == \
            "zero-bubble supports num_chunks=1 only"
        assert "requires zero dropout" in o["refused"]["dropout"]


def test_ring_ticks_compute_no_weight_grad(world):
    """Each stage runs ``M`` real micro-batches: the zero-bubble ring's
    ticks ask for dX alone (``M`` calls without the weight), then the
    fold asks for the weight (``M`` calls); no leaf has a ``.grad``
    while either runs. The AD ring's ticks ask for both. Both give the
    same weight grad."""
    n, outs, _ = world
    for o in outs:
        assert o["seen_zb"] == [(False, False)] * M + [(True, False)] * M
        assert o["seen_ad"] == [(True, False)] * M
        np.testing.assert_allclose(o["count_zb"], o["count_ad"],
                                   atol=1e-5)
