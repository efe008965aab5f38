"""The pipelined fused scan of the port (`jit.PipelineScanTrainStep`: the
layer chunks round-robined over the pp ranks, the ring, the grads
scattered over the flattened (pp, data, mp) group), in gloo ranks on the
CPU at dp 1 x pp 2 (2 ranks), dp 2 x pp 2 and dp 1 x mp 2 x pp 2 (4
ranks), against the JAX package's ``PipelineScanTrainStep`` on a CPU
mesh of the same shape; and at dp 1 x pp 2 with 4 layers, so that a
stage runs two ring passes (V = 2: stage 0 re-injects the first pass's
outputs, the backward hands the cotangents back across the passes, and
the sharded storage gathers the second pass's chunk).

The ranks run `pipeline_selftest`'s ``pp_scan`` case (no jax):
``fleet.init`` with ``pp_degree``, ``dp_degree``, ``mp_degree`` and
``pipeline_configs["accumulate_steps"]`` (2 micro-batches), then
``fleet.distributed_model(gpt).train_step(opt)``, the user's path, on
the rank's dp rows of a global batch (8 x 12 tokens). The tiny scan GPT
(2 layers, one chunk a stage, or 4, two; hidden 64, 2 heads, vocab 96),
weights
drawn with numpy from a seed and carried in by `convert`; tied and
untied heads; AdamW with ``ClipGradByGlobalNorm(0.05)`` (active from the
first step), the LayerNorms and biases out of the decay, the guard on;
both parameter storages. Bars, ROADMAP's training bars: loss |diff| <
5e-4 every step, parameters relative < 5e-3 after 3 steps. Also: the
storages bit-identical and the ranks agreeing; the pp-1 ring (one rank,
here) against pp 2 within 1e-6, with and without hidden dropout (the
masks a function of the data rank, the step, the chunk and the
micro-batch, not of the pp degree); `schedule_stats` equal to the
reference's and the registry's gauges; the numerics rows against the
reference's monitor; the collectives and p2p transfers a step; the
refusals.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.jit.pipeline_step import PipelineScanTrainStep as JPipe
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed.pipeline_selftest import start
from paddle_tpu_torch.distributed.sharding_selftest import small_weights
from paddle_tpu_torch.jit import PipelineScanTrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2,
            num_attention_heads=2, max_position_embeddings=16,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LOSS_BAR, REL_BAR = 5e-4, 5e-3
STEPS, LR, CLIP, MICRO = 3, 1e-2, 0.05, 2
HEADS = ("tied", "untied")
STORAGES = ("replicated", "sharded")
# (dp, pp, mp, layers) of each world
WORLDS = {"dp1pp2": (1, 2, 1, 2), "dp2pp2": (2, 2, 1, 2),
          "dp1mp2pp2": (1, 2, 2, 2), "dp1pp2v2": (1, 2, 1, 4)}


def _config(head, layers=2):
    return dict(TINY, num_layers=layers, tie_word_embeddings=head == "tied")


def _batch():
    rng = np.random.default_rng(1)
    return (rng.integers(0, TINY["vocab_size"], (8, 12)),
            rng.integers(0, TINY["vocab_size"], (8, 12)))


def _excluded(name):
    return "ln" in name or name.endswith("bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_run(named, head, dp, mp, numerics=False, layers=2):
    ids, labels = _batch()
    jenv.reset()
    shape = {"dp": dp, "pp": 2}
    if mp > 1:
        shape["mp"] = mp
    mesh = jenv.build_mesh(shape)
    jenv.set_mesh(mesh)
    try:
        paddle.seed(0)
        jm = JModel(JConfig(**_config(head, layers), scan_layers=True))
        for name, p in jm.named_parameters():
            p._data = jnp.asarray(named[name])
        jm.train()
        out = {p.name for name, p in jm.named_parameters()
               if _excluded(name)}
        opt = popt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP),
                         apply_decay_param_fun=lambda nm: nm not in out)
        kw = dict(mp_axis="mp") if mp > 1 else {}
        step = JPipe(jm, opt, criterion=JCrit(), mesh=mesh, axis="dp",
                     pp_axis="pp", num_micro=MICRO,
                     param_storage="replicated", guard_nonfinite=True,
                     numerics=numerics, **kw)
        t_ids = paddle.to_tensor(ids, dtype="int64")
        t_lab = paddle.to_tensor(labels, dtype="int64")
        if numerics:
            step(t_ids, t_lab)
            return step._numerics.latest_rows(), step.schedule_stats()
        losses = [float(step(t_ids, t_lab)) for _ in range(STEPS)]
        params = {name: np.asarray(p._data)
                  for name, p in jm.named_parameters()}
    finally:
        jenv.reset()
    return losses, params


def _as_ref(params, head, layers):
    tm = GPTForCausalLM(GPTConfig(**_config(head, layers), scan_layers=True),
                        device="cpu")
    return convert.state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in params.items()}, model=tm)


_NAMED = {}


def _named(layers):
    """The weights of each head at ``layers`` layers, drawn once."""
    if layers not in _NAMED:
        _NAMED[layers] = {h: small_weights(_config(h, layers), seed=0)
                          for h in HEADS}
    return _NAMED[layers]


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    dp, pp, mp, layers = WORLDS[request.param]
    named = _named(layers)
    n = dp * pp * mp
    ids, labels = _batch()
    job = start("pp_scan", n, dict(
        config=dict(TINY, num_layers=layers), named=named, ids=ids,
        labels=labels, steps=STEPS, lr=LR, clip=CLIP, pp=pp, mp=mp,
        micro=MICRO, heads=list(HEADS)), timeout=60)
    try:        # the reference, while the ranks run
        ref = {h: _jax_run(named[h], h, dp, mp, layers=layers)
               for h in HEADS}
        ref["rows"] = _jax_run(named["tied"], "tied", dp, mp,
                               numerics=True, layers=layers)
    finally:
        ranks = job.wait(deadline=200)
    return request.param, (dp, pp, mp, layers), ranks, ref


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("head", HEADS)
def test_pp_scan_matches_the_reference(world, head, storage):
    _, (_, _, _, layers), ranks, ref = world
    want_losses, want_params = ref[head]
    tag = f"{head}_{storage}"
    for r, out in enumerate(ranks):
        got = out[f"losses_{tag}"]
        assert np.abs(got - np.asarray(want_losses)).max() < LOSS_BAR, \
            (r, got, want_losses)
        params = _as_ref(out[f"params_{tag}"], head, layers)
        for name, want in want_params.items():
            assert _rel(params[name], want) < REL_BAR, (r, name)


def test_storages_bit_identical_and_ranks_agree(world):
    _, _, ranks, _ = world
    for head in HEADS:
        rep, shd = f"{head}_replicated", f"{head}_sharded"
        for out in ranks:
            np.testing.assert_array_equal(out[f"losses_{rep}"],
                                          out[f"losses_{shd}"])
            for k, v in out[f"params_{rep}"].items():
                np.testing.assert_array_equal(v, out[f"params_{shd}"][k])
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"losses_{rep}"],
                                          ranks[0][f"losses_{rep}"])
            for k, v in out[f"params_{rep}"].items():
                np.testing.assert_array_equal(v, ranks[0][f"params_{rep}"][k])


def test_schedule_stats_and_gauges(world):
    name, (dp, pp, mp, layers), ranks, ref = world
    V = layers // pp
    for out in ranks:
        assert out["stats"] == {
            "pp": 2, "num_micro": MICRO, "layer_chunks": layers,
            "virtual_stages_per_rank": V, "ring_ticks": 3 * V,
            "useful_ticks_per_stage": 2 * V, "bubble_ratio": 1 / 3}
        assert out["gauges"] == [1 / 3, MICRO, 2]
    assert ranks[0]["stats"] == ref["rows"][1]


def test_collectives_and_transfers_a_step(world):
    """The grads scattered once a layer a bucket over the flattened
    (pp, data, mp) group (every stage takes part in every layer's, the
    owner contributing), the outer buckets once; two all-reduces over it
    (the clip and guard's, the loss's) and the loss's over pp; M sends
    and M receives a pass each way; under mp the layers' activations'
    all-reduces, 6 a layer a micro-batch, and the head's 3 on stage 0."""
    name, (dp, pp, mp, L), ranks, _ = world
    V = L // pp
    # without mp the flattened group is the world's
    axes = None if mp == 1 else (("pp", "dp", "mp") if dp > 1 else
                                 ("pp", "dp", "sharding", "mp"))
    flat = "world" if axes is None else "+".join(axes)
    for out in ranks:
        d, stage, m = out["coords"]
        assert out["axes"] == [axes, ("pp",)]
        for head in HEADS:
            nb = len(out[f"buckets_{head}"])
            for storage in STORAGES:
                got = dict(out[f"calls_{head}_{storage}"]["by_group"])
                s_b, o_b = nb - 1, 1
                gathers = (2 * L * s_b if storage == "sharded"
                           else L * s_b) + o_b
                want = {f"reduce_scatter@{flat}": L * s_b + o_b,
                        f"all_gather@{flat}": gathers,
                        f"all_reduce@{flat}": 2, "all_reduce@pp": 1,
                        "send@pp": 2 * V * MICRO,
                        "recv@pp": 2 * V * MICRO}
                if mp > 1:
                    want["all_reduce@mp"] = (6 * (L // pp) * MICRO
                                             + (3 if stage == 0 else 0))
                assert got == want, (stage, storage, got)


_PP1 = {}


def _pp1(layers):
    """The pp-1 ring in this process (a world of one, the full batch) at
    ``layers`` layers: 3 steps with the clip and the guard, and one with
    hidden dropout 0.5 from torch's seed 0."""
    if layers not in _PP1:
        _PP1[layers] = _run_pp1(_named(layers), layers)
    return _PP1[layers]


@pytest.fixture(scope="module")
def pp1():
    return _pp1


def _run_pp1(named, layers):
    ids, labels = _batch()
    tenv.init_parallel_env(backend="gloo")
    losses = {}
    try:
        mesh = tenv.build_mesh({"pp": 1, "dp": 1})
        tenv.set_mesh(mesh)
        for drop in (0.0, 0.5):
            torch.manual_seed(0)
            cfg = dict(_config("tied", layers), hidden_dropout_prob=drop)
            tm = GPTForCausalLM(GPTConfig(**cfg, scan_layers=True),
                                device="cpu")
            tm.load_state_dict(convert.state_dict_from_jax(named["tied"],
                                                           model=tm))
            tm.train()
            opt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                        grad_clip=None if drop else ClipGradByGlobalNorm(
                            CLIP),
                        apply_decay_param_fun=lambda nm: not _excluded(nm))
            step = PipelineScanTrainStep(
                tm, opt, criterion=GPTPretrainingCriterion(), mesh=mesh,
                num_micro=MICRO, param_storage="replicated",
                guard_nonfinite=not drop, numerics=False)
            assert step.schedule_stats()["bubble_ratio"] == 0.0
            b = [torch.from_numpy(x) for x in (ids, labels)]
            losses[drop] = [float(step(*b))
                            for _ in range(1 if drop else STEPS)]
    finally:
        tenv.reset()
    return losses


def test_the_pp1_ring_against_pp2(world, pp1):
    """A pp of degree 1 is the sequential accumulation: its losses equal
    the pp-2 ranks' within 1e-6."""
    _, (_, _, _, layers), ranks, _ = world
    want = pp1(layers)[0.0]
    for out in ranks:
        got = out["losses_tied_replicated"]
        assert np.abs(got - np.asarray(want)).max() < 1e-6, (got, want)


def test_dropout_masks(world, pp1):
    """Hidden dropout 0.5, every rank on the whole batch: two runs from
    the same seed draw the same masks; the masks are alike over the pp
    and mp ranks and distinct over the data ranks; data rank 0's are the
    pp-1 ring's (the masks are a function of the data rank, the step,
    the chunk and the micro-batch, not of the pp degree)."""
    _, (dp, _, _, layers), ranks, _ = world
    pp1 = pp1(layers)
    by_dp = {}
    for out in ranks:
        first, again = out["dropout"]
        assert first == again
        by_dp.setdefault(out["coords"][0], set()).add(first[1])
        if out["coords"][0] == 0:
            assert abs(first[1] - pp1[0.5][0]) < 1e-6, (first, pp1)
            assert abs(first[1] - pp1[0.0][0]) > 1e-3     # masks acted
    assert all(len(v) == 1 for v in by_dp.values())
    assert len({v.pop() for v in by_dp.values()}) == dp


def test_numerics_rows_against_the_reference(world):
    """The monitor's rows (each chunk's charged to its logical id, the
    outer row) against the reference's PipelineScanTrainStep's on the
    same mesh and batch."""
    name, _, ranks, ref = world
    want, _ = ref["rows"]
    for out in ranks:
        got = out["rows"]
        assert len(got) == len(want) == WORLDS[name][3] + 1
        for g, w in zip(got, want):
            for key in ("grad_norm", "param_norm", "act_rms"):
                if key in w and w[key] is not None:
                    assert abs(g[key] - w[key]) <= 1e-3 * max(abs(w[key]),
                                                               1e-6), \
                        (key, g, w)


def test_refusals(world):
    _, _, ranks, _ = world
    refused = ranks[0]["refused"]
    assert "not divisible by pp degree" in refused["chunks"]
    assert "not divisible by num_micro" in refused["micro"]


def test_num_micro_refused_off_a_pp_mesh():
    """A micro-batch count is the pipeline's: ``select_train_step`` on a
    mesh without a pp axis above degree 1 refuses it."""
    from paddle_tpu_torch.jit.sharded_scan import select_train_step

    tenv.init_parallel_env(backend="gloo")
    try:
        mesh = tenv.build_mesh({"pp": 1, "dp": 1})
        tenv.set_mesh(mesh)
        tm = GPTForCausalLM(GPTConfig(**_config("tied"), scan_layers=True),
                            device="cpu")
        opt = AdamW(learning_rate=LR, parameters=tm.parameters())
        with pytest.raises(ValueError, match="num_micro=2"):
            select_train_step(tm, opt, criterion=GPTPretrainingCriterion(),
                              mesh=mesh, num_micro=2)
    finally:
        tenv.reset()
