"""The pipeline ring and the eager pipeline of the port, in gloo ranks on
the CPU, against the JAX package on a CPU mesh of the same size (or its
single controller, where the reference runs one). The worlds: pp 2 and
pp 4 (2 and 4 ranks), and dp 2 x pp 2 and sharding 2 x pp 2 (4 ranks,
each data rank on its own rows of the batch, its ring over its own pp
group; the reference runs the whole batch).

The ranks run `pipeline_selftest`'s cases (no jax):

* ``ring``: `collective.p2p_permute` (values, a partial permutation's
  zeros, the reverse-ring backward) against ``jax.lax.ppermute``;
  `pipeline_spmd` over the tanh-linear block of ``tests/test_pipeline.py``
  at micro-batch counts 1, 3 and 4 and ``num_chunks`` 2, outputs within
  1e-5 and the grads of the rank's stage and of the input within 1e-5 of
  the largest of the reference's `pipeline_spmd`; `pipeline_spmd_hetero` whose first stage
  shifts integer token ids and whose second embeds them (ids cross the
  ring exactly), against the reference's;
* ``pp_layers``: a `PipelineLayer` with a tied `SharedLayerDesc`
  embedding through ``fleet.distributed_model`` (`PipelineParallel`) and
  ``fleet.distributed_optimizer``: 3 ``train_batch`` steps with AdamW,
  ``ClipGradByGlobalNorm`` and a `GradScaler` at ``accumulate_steps`` 2
  and 4 against the reference's `PipelineParallel` (loss |diff| < 5e-4,
  the union of the ranks' parameters within 5e-3 relative: over the data
  axes the grads and the loss are the global batch's, and under sharding
  the clip counts the tied weight once), its ``eval_batch``, and a step
  with an inf in the last stage's grads: every stage skips it and halves
  its scale, as the reference's scaler does (the non-finite flag is one
  flag over the pp group);
* ``gpt_pipe``: `GPTForCausalLMPipe` at chunks 1 and 2, loss and grads
  within 1e-5 of the reference's model, the weights carried both ways by
  `convert.pipe_stage_from_jax` / `pipe_stage_to_jax`; the zero-bubble
  ring (``use_zero_bubble=True``) on the chunks-1 weights within the
  reference's zero-bubble bars (loss 1e-5, grads 2e-4);
* ``ring`` also runs `pipeline_spmd_zb` on the chunks-1 stages, held to
  the reference's ring within its zero-bubble bars (outputs 1e-5, grads
  1e-4).

In this process: `PipelineLayer`'s stage bounds against the reference's
``segment_parts`` ("uniform" and "layer:ClassName"), and what a rank
builds: its own stage's entries alone, under the reference's names.
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer,
    SharedLayerDesc as JSharedLayerDesc)
from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel import (
    PipelineParallel as JPipelineParallel)
from paddle_tpu.distributed.fleet.meta_parallel.spmd_pipeline import (
    microbatch as jmicro, pipeline_spmd as jpipe,
    pipeline_spmd_hetero as jhetero, unmicrobatch as junmicro)
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLMPipe as JGPTPipe
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.pipeline_selftest import (start,
                                                            tiny_pipe_model)

H, LPS, MB = 16, 2, 2
SPMD = {"m1": (1, 1), "m3": (3, 1), "m4": (4, 1), "m4c2": (4, 2)}
DIMS = dict(vocab=32, hidden=16, blocks=4)
LR, CLIP, STEPS = 1e-2, 0.5, 3
# Adam's epsilon near the clipped grads' size, so the update follows the
# clip's scale (a wrong global norm shows in the parameters)
EPS = 1e-3
ACCUMULATE = (2, 4)
# (dp, sharding, pp) of each world
WORLDS = {"pp2": (1, 1, 2), "pp4": (1, 1, 4), "dp2pp2": (2, 1, 2),
          "sh2pp2": (1, 2, 2)}
GPT = dict(vocab_size=64, hidden_size=32, num_layers=4,
           num_attention_heads=2, max_position_embeddings=16,
           hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("pp",))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# -- the ring's arguments and the reference's results -----------------------

def _ring_args(n):
    rng = np.random.default_rng(0)
    a = {"perm_x": rng.standard_normal((n, 3)).astype(np.float32),
         "perm_w": rng.standard_normal((n, 3)).astype(np.float32),
         "spmd": SPMD, "W": {}, "x": {}}
    for key, (M, nc) in SPMD.items():
        a["W"][key] = (rng.standard_normal((n, nc, LPS, H, H)) * 0.3
                       ).astype(np.float32)
        a["x"][key] = rng.standard_normal((M * MB, H)).astype(np.float32)
    a["het"] = {"ids": rng.integers(0, 30, (4, MB, 5)),
                "E": rng.standard_normal((31, H)).astype(np.float32),
                "Ws": (rng.standard_normal((n, H, H)) * 0.3
                       ).astype(np.float32),
                "R": rng.standard_normal((4, MB, 5, H)).astype(np.float32)}
    return a


def _jax_block(ws, x):
    y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)
    return y


def _ring_ref(n, a):
    mesh = _mesh(n)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def permuted(x):
        return jax.shard_map(lambda v: jax.lax.ppermute(v, "pp", perm),
                             mesh=mesh, in_specs=P("pp"),
                             out_specs=P("pp"))(x)

    x, w = jnp.asarray(a["perm_x"]), jnp.asarray(a["perm_w"])
    ref = {"perm": (permuted(x),
                    jax.grad(lambda v: jnp.sum(permuted(v) * w))(x))}
    for key, (M, nc) in SPMD.items():
        W = jnp.asarray(a["W"][key] if nc > 1 else a["W"][key][:, 0])

        def piped(W, xs, M=M, nc=nc):
            return junmicro(jpipe(_jax_block, W, jmicro(xs, M), mesh=mesh,
                                  axis="pp", num_chunks=nc))

        xs = jnp.asarray(a["x"][key])
        out = piped(W, xs)
        gW, gx = jax.grad(lambda W, xs: jnp.sum(jnp.sin(piped(W, xs))),
                          (0, 1))(W, xs)
        ref[key] = (out, gW, gx)
    h = a["het"]
    fns = ([lambda p, t: t + 1, lambda p, t: p["e"][t]]
           + [lambda p, t: jnp.tanh(t @ p["w"])] * (n - 2))

    def het(E, Ws):
        params = [{}, {"e": E}] + [{"w": Ws[r]} for r in range(2, n)]
        return jhetero(fns, params, jnp.asarray(h["ids"]), mesh=mesh)

    E, Ws = jnp.asarray(h["E"]), jnp.asarray(h["Ws"])
    R = jnp.asarray(h["R"])
    ref["het"] = (het(E, Ws), *jax.grad(
        lambda E, Ws: jnp.sum(het(E, Ws) * R), (0, 1))(E, Ws))
    return ref


# -- the tiny pipeline model of the reference ---------------------------------

class EmbedPipe(jnn.Embedding):
    pass


class TanhLinear(jnn.Linear):
    def forward(self, x):
        return paddle.tanh(super().forward(x))


def _jax_head(layer, x):
    return paddle.matmul(x, layer.weight, transpose_y=True)


def _jax_ce(logits, labels):
    return jnn.functional.cross_entropy(
        logits.reshape([-1, logits.shape[-1]]), labels.reshape([-1]))


def _jax_descs(vocab, hidden, blocks):
    return ([JSharedLayerDesc("embed", EmbedPipe, None, "weight", vocab,
                              hidden)]
            + [JLayerDesc(TanhLinear, hidden, hidden)
               for _ in range(blocks)]
            + [JSharedLayerDesc("embed", EmbedPipe, _jax_head, "weight",
                                vocab, hidden)])


def _pp_named():
    pl = JPipelineLayer(_jax_descs(**DIMS), num_stages=1, loss_fn=_jax_ce)
    rng = np.random.default_rng(2)
    return {k: (rng.standard_normal(np.shape(v._data)) * 0.3).astype(
        np.float32) for k, v in pl.state_dict().items()}


def _pp_batch():
    rng = np.random.default_rng(3)
    return (rng.integers(0, DIMS["vocab"], (8, 6)),
            rng.integers(0, DIMS["vocab"], (8, 6)))


def _jax_pp(named, accumulate, steps=STEPS, poison=False):
    pl = JPipelineLayer(_jax_descs(**DIMS), num_stages=1, loss_fn=_jax_ce)
    for k, p in pl.state_dict().items():
        p._data = jnp.asarray(named[k])
    opt = popt.AdamW(learning_rate=LR, parameters=pl.parameters(),
                     epsilon=EPS, grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0)
    ids, labels = (paddle.to_tensor(x, dtype="int64") for x in _pp_batch())
    if poison:
        loss = pl._loss_fn(pl(ids), labels)
        scaler.scale(loss).backward()
        p = pl.parameters()[-1]
        p.grad._data = p.grad._data.at[0].set(jnp.inf)
        scaler.step(opt)
        scaler.update()
        return ({k: np.asarray(v._data) for k, v in pl.state_dict().items()},
                float(scaler.get_loss_scaling()))
    pp = JPipelineParallel(pl, None, SimpleNamespace(
        pipeline_configs={"accumulate_steps": accumulate}))
    with warnings.catch_warnings():     # "runs micro-steps SEQUENTIALLY"
        warnings.simplefilter("ignore", RuntimeWarning)
        losses = [float(pp.train_batch((ids, labels), opt, scaler=scaler))
                  for _ in range(steps)]
    ev = float(pp.eval_batch((ids, labels)))
    return (losses, {k: np.asarray(v._data) for k, v in
                     pl.state_dict().items()}, ev)


def _gpt_named(nc, n):
    pipe = JGPTPipe(JConfig(**GPT), num_stages=n, num_micro=2,
                    num_chunks=nc, mesh=_mesh(n))
    rng = np.random.default_rng(4 + nc)
    named = {}
    for name, p in pipe.named_parameters():
        w = rng.standard_normal(np.shape(p._data)).astype(np.float32)
        named[name] = (w * 0.05 if name.endswith("bias") else
                       1.0 + 0.1 * w if "ln" in name else w * 0.1)
    return named


def _gpt_batch():
    rng = np.random.default_rng(6)
    return (rng.integers(0, GPT["vocab_size"], (4, 8)),
            rng.integers(0, GPT["vocab_size"], (4, 8)))


def _jax_gpt(named, nc, n):
    pipe = JGPTPipe(JConfig(**GPT), num_stages=n, num_micro=2,
                    num_chunks=nc, mesh=_mesh(n))
    for name, p in pipe.named_parameters():
        p._data = jnp.asarray(named[name])
    ids, labels = (paddle.to_tensor(x, dtype="int64") for x in _gpt_batch())
    loss = JCrit()(pipe(ids), labels)
    loss.backward()
    return float(loss), {name: np.asarray(p.grad._data)
                         for name, p in pipe.named_parameters()}


_REF = {}


def _reference(n, pp_named):
    """The reference's ring at ``n`` stages and its eager pipeline (the
    whole batch: alike in every world), each computed once."""
    if n not in _REF:
        _REF[n] = _ring_ref(n, _ring_args(n))
    if "pp" not in _REF:
        _REF["pp"] = {acc: _jax_pp(pp_named, acc) for acc in ACCUMULATE}
        _REF["poison"] = _jax_pp(pp_named, ACCUMULATE[0], poison=True)
    return {"ring": _REF[n], "pp": _REF["pp"], "poison": _REF["poison"]}


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    dp, sh, n = WORLDS[request.param]
    ranks = dp * sh * n
    ids, labels = _pp_batch()
    pp_named = _pp_named()
    axes = dict(dp=dp, sharding=sh)
    jobs = {"ring": start("ring", ranks, dict(_ring_args(n), **axes),
                          timeout=60),
            "pp_layers": start("pp_layers", ranks, dict(
                dims=DIMS, named=pp_named, ids=ids, labels=labels,
                steps=STEPS, lr=LR, clip=CLIP, eps=EPS,
                accumulate=list(ACCUMULATE), **axes), timeout=60)}
    got = {}
    try:        # the reference, while the ranks run
        ref = _reference(n, pp_named)
    finally:
        for name, job in jobs.items():
            got[name] = job.wait(deadline=200)
    return n, got, ref, dict(pp_named=pp_named, inner=dp * sh)


@pytest.fixture(scope="module")
def gpt_world():
    """`GPTForCausalLMPipe` at pp 2 in two ranks, and the reference's."""
    ids, labels = _gpt_batch()
    named = {nc: _gpt_named(nc, 2) for nc in (1, 2)}
    job = start("gpt_pipe", 2, dict(config=GPT, named=named, ids=ids,
                                    labels=labels, micro=2), timeout=60)
    try:
        ref = {nc: _jax_gpt(named[nc], nc, 2) for nc in (1, 2)}
    finally:
        outs = job.wait(deadline=200)
    return outs, ref


def test_p2p_permute_and_its_backward(world):
    n, got, ref, _ = world
    want_y, want_g = (np.asarray(t) for t in ref["ring"]["perm"])
    a0 = _ring_args(n)["perm_x"][0]       # [(0, n - 1)] alone: n - 1 gets it
    for out in got["ring"]:
        r = out["stage"]
        y, g = out["perm"]
        np.testing.assert_array_equal(y, want_y[r])
        np.testing.assert_allclose(g, want_g[r], rtol=1e-6)
        want = a0 if r == n - 1 else np.zeros_like(a0)
        np.testing.assert_array_equal(out["perm_partial"], want)


@pytest.mark.parametrize("key", list(SPMD))
def test_pipeline_spmd_against_the_reference(world, key):
    n, got, ref, _ = world
    M, nc = SPMD[key]
    out, gW, gx = (np.asarray(t) for t in ref["ring"][key])
    for o in got["ring"]:
        r = o["stage"]
        y, w_grad, x_grad = o[f"spmd_{key}"]
        np.testing.assert_allclose(y, out, atol=1e-5)
        assert _rel(w_grad, gW[r]) < 1e-5 and _rel(x_grad, gx) < 1e-5, \
            (_rel(w_grad, gW[r]), _rel(x_grad, gx))


@pytest.mark.parametrize("key", [k for k, (_, nc) in SPMD.items()
                                 if nc == 1])
def test_pipeline_spmd_zb_against_the_reference(world, key):
    """The zero-bubble ring on the same stages: the reference's
    zero-bubble bars against its AD ring (tests/test_pipeline.py:294-325:
    outputs 1e-5, grads 1e-4)."""
    n, got, ref, _ = world
    out, gW, gx = (np.asarray(t) for t in ref["ring"][key])
    for o in got["ring"]:
        r = o["stage"]
        y, w_grad, x_grad = o[f"zb_{key}"]
        np.testing.assert_allclose(y, out, atol=1e-5)
        np.testing.assert_allclose(w_grad, gW[r], atol=1e-4)
        np.testing.assert_allclose(x_grad, gx, atol=1e-4)


def test_pipeline_spmd_hetero_with_token_ids(world):
    n, got, ref, _ = world
    out, gE, gW = (np.asarray(t) for t in ref["ring"]["het"])
    for o in got["ring"]:
        r = o["stage"]
        y = o["het"][0]
        np.testing.assert_allclose(y, out, atol=1e-5)
        if r == 1:
            np.testing.assert_allclose(o["het"][1], gE, atol=1e-5)
        elif r > 1:
            np.testing.assert_allclose(o["het"][1], gW[r], atol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("seg", ["uniform", "layer:TanhLinear"])
def test_pipeline_layer_bounds_and_what_a_stage_holds(n, seg):
    """The port's bounds are the reference's; stage s builds its own
    entries alone, under the reference's names."""
    jl = JPipelineLayer(_jax_descs(**DIMS), num_stages=n, seg_method=seg)
    keys = set(JPipelineLayer(_jax_descs(**DIMS), num_stages=1)
               .state_dict())
    union = set()
    for s in range(n):
        tl = tiny_pipe_model(**DIMS, num_stages=n, stage_id=s,
                             seg_method=seg)
        assert tl.segment_parts == jl.segment_parts
        lo, hi = tl.segment_parts[s], tl.segment_parts[s + 1]
        held = set(tl.state_dict())
        union |= held
        assert len(tl.run_function) == hi - lo
        # an entry's global layer index names it: tanh-linear i is
        # _layers_list.{i + 1}
        for i in range(lo, hi):
            if 0 < i <= DIMS["blocks"]:
                assert f"_layers_list.{i}.weight" in held
        assert all(not (0 < int(k.split(".")[1]) <= DIMS["blocks"])
                   or lo <= int(k.split(".")[1]) < hi for k in held)
    assert union == keys


@pytest.mark.parametrize("acc", ACCUMULATE)
def test_pipeline_parallel_train_batch(world, acc):
    n, got, ref, extra = world
    want_losses, want_params, _ = ref["pp"][acc]
    outs = got["pp_layers"]
    models = [tiny_pipe_model(**DIMS, num_stages=n, stage_id=r)
              for r in range(n)]
    for out in outs:
        t = out[f"train_{acc}"]
        assert t["wrapper"] == "PipelineParallel"
        assert np.abs(t["losses"] - np.asarray(want_losses)).max() < 5e-4, \
            (t["losses"], want_losses)
        assert t["scale"] == 1024.0
    # stage s's ranks are s * inner ... (s + 1) * inner - 1 (pp outermost)
    inner = extra["inner"]
    for d in range(inner):
        line = outs[d::inner]
        union = convert.pipeline_state_dict_to_jax(
            [{k: torch.from_numpy(v) for k, v in o[f"train_{acc}"]["state"]
              .items()} for o in line], models)
        assert set(union) == set(want_params)
        for k, want in want_params.items():
            assert _rel(union[k], want) < 5e-3, (d, k)
        # the tied embedding's copies stay alike on the first and last
        # stage
        first = line[0][f"train_{acc}"]["state"]["_layers_list.0.weight"]
        np.testing.assert_array_equal(
            line[-1][f"train_{acc}"]["state"]["_layers_list.0.weight"],
            first)
    # the data ranks of a stage hold the same parameters
    for r, out in enumerate(outs):
        for k, v in out[f"train_{acc}"]["state"].items():
            np.testing.assert_array_equal(
                v, outs[r - r % inner][f"train_{acc}"]["state"][k])


def test_eval_batch(world):
    n, got, ref, _ = world
    want = ref["pp"][ACCUMULATE[-1]][2]
    for out in got["pp_layers"]:
        assert abs(out["eval"] - want) < 5e-4, (out["eval"], want)


def test_nonfinite_step_skipped_on_every_stage(world):
    """An inf in the last stage's grads: every stage skips the step
    (its parameters are the starting ones, bit for bit) and halves its
    scale, as the reference's scaler skips and halves."""
    n, got, ref, extra = world
    want_params, want_scale = ref["poison"]
    named = extra["pp_named"]
    for k, v in want_params.items():                   # the reference
        np.testing.assert_array_equal(v, named[k])
    assert want_scale == 512.0
    for r, out in enumerate(got["pp_layers"]):
        assert out["poison"]["scale"] == want_scale
        model = tiny_pipe_model(**DIMS, num_stages=n,
                                stage_id=r // extra["inner"])
        start_ = convert.pipeline_state_dict_from_jax(named, model)
        assert set(out["poison"]["after"]) == set(start_)
        for k, v in out["poison"]["after"].items():
            np.testing.assert_array_equal(v, start_[k].numpy())


def test_topology_at_pp_the_world(world):
    """The stage and the p2p neighbours (global ranks; pp outermost, so
    a stage's ranks are ``inner`` apart from the next stage's)."""
    n, got, _, extra = world
    inner = extra["inner"]
    for r, out in enumerate(got["pp_layers"]):
        s, d = divmod(r, inner)
        assert out["hcg"] == [n, s, s == 0, s == n - 1,
                              (s + 1) % n * inner + d,
                              (s - 1) % n * inner + d]


def _joined(outs, key, nc=1):
    return convert.pipe_stage_to_jax(
        [{k: torch.from_numpy(v) for k, v in o[key]["grads"].items()}
         for o in sorted(outs, key=lambda o: o[nc]["stage"])], None)


@pytest.mark.parametrize("nc", [1, 2])
def test_gpt_pipe_loss_and_grads(gpt_world, nc):
    """Chunks ``nc`` within 1e-5 of the reference's model; the
    zero-bubble ring (``use_zero_bubble=True``, chunks 1) ran on the
    chunks-1 weights and matched it within the reference's zero-bubble
    bars (loss 1e-5, grads 2e-4: tests/test_pipeline.py:511-557)."""
    outs, ref = gpt_world
    want_loss, want_grads = ref[nc]
    for out in outs:
        assert abs(out[nc]["loss"] - want_loss) < 1e-5
        assert abs(out["zb"]["loss"] - ref[1][0]) < 1e-5
    joined = _joined(outs, nc, nc)
    assert set(joined) == set(want_grads)
    for k, want in want_grads.items():
        np.testing.assert_allclose(joined[k], want, atol=1e-5, err_msg=k)
    zb = _joined(outs, "zb")
    assert set(zb) == set(ref[1][1])
    for k, want in ref[1][1].items():
        np.testing.assert_allclose(zb[k], want, atol=2e-4, err_msg=k)
