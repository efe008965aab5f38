"""The dp x mp sharded fused scan of the port (``mp_axis``: Megatron
tensor parallelism inside each layer, the vocab-parallel head), in 2
gloo ranks (dp 1 x mp 2) and 4 (dp 2 x mp 2) on the CPU, against the
JAX package's ``ShardedFusedScanTrainStep(mp_axis="mp")`` on a CPU mesh
of the same shape.

The ranks run `mp_selftest`'s ``mp_scan`` case (no jax): ``fleet.init``
with ``dp_degree`` / ``mp_degree``, then
``fleet.distributed_model(gpt).train_step(opt)``, the user's path, on
the rank's dp rows of a global batch (8 x 12 tokens). The reference's
tiny scan GPT (2 layers, hidden 64, 2 heads, vocab 96: V/mp = 48, a
ragged vocab tile), weights drawn with numpy from a seed and carried in
by `convert`; tied and untied heads; AdamW with ``ClipGradByGlobalNorm
(0.05)`` (active from the first step), the LayerNorms and biases out of
the decay, the guard on; both parameter storages. Bars, ROADMAP's
training bars: loss |diff| < 5e-4 every step, parameters relative <
5e-3 after 3 steps, and the same bar on the updates of ``ln_f`` and of
the row-parallel biases alone (replicated leaves, whose grads every mp
rank holds whole: a wrong scale would show there first). Also: the
storages bit-identical, the ranks agreeing; hidden-dropout masks alike
across mp ranks and distinct across dp ranks; the collectives a step
(the port's counterpart of the reference's HLO receipt
``test_mp_hlo_grads_reduced_in_scan_no_full_gather``); the blocks a
rank binds joined back into the reference's arrays bit for bit; the
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
from paddle_tpu.jit import ShardedFusedScanTrainStep as JSharded
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.mp_selftest import start
from paddle_tpu_torch.distributed.sharding_selftest import small_weights
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2,
            num_attention_heads=2, max_position_embeddings=16,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LOSS_BAR, REL_BAR = 5e-4, 5e-3
STEPS, LR, CLIP, MP = 3, 1e-2, 0.05, 2
HEADS = ("tied", "untied")
STORAGES = ("replicated", "sharded")
REPLICATED = ("gpt.ln_f.weight", "gpt.ln_f.bias",
              "gpt.blocks.blocks__attn__out_proj__bias",
              "gpt.blocks.blocks__mlp__fc2__bias")


def _config(head):
    return dict(TINY, tie_word_embeddings=head == "tied")


def _batch():
    rng = np.random.default_rng(1)
    return (rng.integers(0, TINY["vocab_size"], (8, 12)),
            rng.integers(0, TINY["vocab_size"], (8, 12)))


def _named():
    return {h: small_weights(_config(h), seed=0) for h in HEADS}


def _excluded(name):
    return "ln" in name or name.endswith("bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_run(named, head, dp):
    ids, labels = _batch()
    jenv.reset()
    mesh = jenv.build_mesh({"dp": dp, "mp": MP})
    jenv.set_mesh(mesh)
    try:
        paddle.seed(0)
        jm = JModel(JConfig(**_config(head), scan_layers=True))
        for name, p in jm.named_parameters():
            p._data = jnp.asarray(named[name])
        jm.train()
        out = {p.name for name, p in jm.named_parameters()
               if _excluded(name)}
        opt = popt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP),
                         apply_decay_param_fun=lambda nm: nm not in out)
        step = JSharded(jm, opt, criterion=JCrit(), mesh=mesh, axis="dp",
                        mp_axis="mp", param_storage="replicated",
                        guard_nonfinite=True, numerics=False)
        t_ids = paddle.to_tensor(ids, dtype="int64")
        t_lab = paddle.to_tensor(labels, dtype="int64")
        losses = [float(step(t_ids, t_lab)) for _ in range(STEPS)]
        params = {name: np.asarray(p._data)
                  for name, p in jm.named_parameters()}
    finally:
        jenv.reset()
    return losses, params


def _as_ref(params, head):
    tm = GPTForCausalLM(GPTConfig(**_config(head), scan_layers=True),
                        device="cpu")
    return convert.state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in params.items()}, model=tm)


@pytest.fixture(scope="module")
def named():
    return _named()


@pytest.fixture(scope="module", params=[2, 4], ids=["dp1mp2", "dp2mp2"])
def world(request, named):
    n = request.param
    ids, labels = _batch()
    job = start("mp_scan", n, dict(
        config=TINY, named=named, ids=ids, labels=labels, steps=STEPS,
        lr=LR, clip=CLIP, mp=MP, heads=list(HEADS)), timeout=60)
    try:        # the reference, while the ranks run
        ref = {h: _jax_run(named[h], h, n // MP) for h in HEADS}
    finally:
        ranks = job.wait(deadline=150)
    return n, ranks, ref


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("head", HEADS)
def test_mp_scan_matches_the_reference(world, head, storage):
    n, ranks, ref = world
    want_losses, want_params = ref[head]
    tag = f"{head}_{storage}"
    for r, out in enumerate(ranks):
        got = out[f"losses_{tag}"]
        assert np.abs(got - np.asarray(want_losses)).max() < LOSS_BAR, \
            (r, got, want_losses)
        params = _as_ref(out[f"params_{tag}"], head)
        for name, want in want_params.items():
            assert _rel(params[name], want) < REL_BAR, (r, name)


@pytest.mark.parametrize("head", HEADS)
def test_replicated_leaves_updates_alone(world, named, head):
    """ln_f's and the row-parallel biases' updates, each against the
    reference's update: they take the 1/mp scale of a grad that every
    mp rank holds whole."""
    n, ranks, ref = world
    _, want_params = ref[head]
    start_ = named[head]
    for out in ranks:
        params = _as_ref(out[f"params_{head}_sharded"], head)
        for name in REPLICATED:
            got = params[name] - start_[name]
            want = want_params[name] - start_[name]
            assert np.abs(want).max() > 1e-3, name
            assert _rel(got, want) < REL_BAR, (name, _rel(got, want))


def test_storages_bit_identical_and_ranks_agree(world):
    n, ranks, _ = world
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


def test_dropout_masks_alike_across_mp_distinct_across_dp(world):
    """Every rank trains the same rows with hidden dropout 0.5: the masks
    alone part the ranks' losses."""
    n, ranks, _ = world
    by_dp = {}
    for out in ranks:
        d, m = out["coords"]
        by_dp.setdefault(d, set()).add(out["dropout_local"])
    assert all(len(v) == 1 for v in by_dp.values())      # alike over mp
    assert len({v.pop() for v in by_dp.values()}) == n // MP   # per dp


def test_collectives_a_step(world):
    """The activations' all-reduces over the mp group (2 a layer forward,
    2 in the recompute, 2 in the backward; the head's max, sum and dh),
    the grads scattered once over the flattened (dp, mp) group, and no
    mp-only gradient all-reduce or gather."""
    n, ranks, _ = world
    L = TINY["num_layers"]
    flat = "dp+mp" if n > MP else "dp+sharding+mp"
    for out in ranks:
        assert out["axes"] == [tuple(flat.split("+")), ("mp",)]
        for head in HEADS:
            for storage in STORAGES:
                got = out[f"calls_{head}_{storage}"]["by_group"]
                gathers = 2 * L + 1 if storage == "sharded" else L + 1
                assert got == {f"all_reduce@mp": 6 * L + 3,
                               f"reduce_scatter@{flat}": L + 1,
                               f"all_reduce@{flat}": 2,
                               f"all_gather@{flat}": gathers}, got
                sh = out[f"shards_{head}_{storage}"]
                assert [s // L for s in sh["s"]] + sh["o"] == \
                    [b // n for b in out[f"buckets_{head}"]]


@pytest.mark.parametrize("head", HEADS)
def test_the_blocks_join_into_the_reference_arrays(world, named, head):
    """What each rank binds (`convert.mp_block` under the step's plan:
    qkv by heads, fc1 by output rows, out_proj and fc2 by input columns,
    the head's vocab rows) joined over the ranks of an mp group is the
    reference's array, bit for bit."""
    n, ranks, _ = world
    tm = GPTForCausalLM(GPTConfig(**_config(head), scan_layers=True),
                        device="cpu")
    mp_ranks = [out for out in ranks if out["coords"][0] == 0]
    plan = mp_ranks[0][f"plan_{head}"]
    # qkv's weight and bias, out_proj's weight, fc1's weight and bias,
    # fc2's weight; and the head's rows
    assert len([k for k in plan if "blocks__" in k]) == 6
    assert len(plan) == 7
    joined = {k: convert.mp_join(
        [torch.from_numpy(out[f"blocks_{head}"][k]) for out in mp_ranks],
        kind) for k, kind in plan.items()}
    back = convert.state_dict_to_jax(joined, model=tm)
    for k in plan:
        np.testing.assert_array_equal(back[k], named[head][k])


def test_refusals(world):
    n, ranks, _ = world
    refused = ranks[0]["refused"]
    assert "num_attention_heads" in refused["heads"]
    assert "attention dropout" in refused["attention_dropout"]
    assert "GPTPretrainingCriterion" in refused["criterion"]
