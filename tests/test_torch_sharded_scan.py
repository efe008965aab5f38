"""`jit.ShardedFusedScanTrainStep` of the port, in 2 and 4 gloo ranks on
the CPU, against the JAX package's on a CPU mesh of the same degree.

Weights are drawn with numpy from a seed on the reference's tiny scan
GPT (2 layers, hidden 64, dropout 0) and carried into the port's by
`convert`; the global batch (8 x 12 tokens) is split on dim 0, rank r
taking block r, as the reference's mesh places block r on device r. The
ranks run `paddle_tpu_torch.distributed.sharding_selftest` (no jax), one
launch a degree for every case here, under the launcher's deadline.
AdamW with ``ClipGradByGlobalNorm(0.05)`` (active from the first step),
the LayerNorms and biases out of the decay, the guard on. Bars,
ROADMAP's training bars (both ``layer_chunk`` values against the
reference's ``layer_chunk=1``, which its own tests hold equal to its
other chunkings): loss |diff| < 5e-4 every step, parameters
relative < 5e-3 after 3 steps (with ``comm_quant="int8"``, the
reference's comm-quant bar, 1e-2 relative, against its quantized and
its exact runs); the two storages bit-identical; the clip
against the port's eager global-norm clip on the whole batch 5e-4 /
5e-3 too.
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
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed.sharding_selftest import start
from paddle_tpu_torch.jit import (FusedScanTrainStep,
                                  ShardedFusedScanTrainStep, TrainStep,
                                  select_train_step)
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2,
            num_attention_heads=2, max_position_embeddings=16,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LOSS_BAR, REL_BAR = 5e-4, 5e-3
STEPS, LR, CLIP = 3, 1e-2, 0.05
CHUNKS = (1, 2)


def _excluded(name):
    return "ln" in name or name.endswith("bias")


def _weights(seed=0):
    paddle.seed(0)
    jm = JModel(JConfig(**TINY, scan_layers=True))
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        named[name] = (a * 0.05 if name.endswith("bias") else
                       1.0 + 0.1 * a if "ln" in name else a * 0.1)
    return named


def _batch():
    rng = np.random.default_rng(1)
    return (rng.integers(0, TINY["vocab_size"], (8, 12)),
            rng.integers(0, TINY["vocab_size"], (8, 12)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _port_model(named):
    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=True), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    tm.train()
    return tm


def _as_ref(params):
    """A rank's returned port state dict under the reference's names."""
    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=True), device="cpu")
    return convert.state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in params.items()}, model=tm)


def _jax_run(named, n, chunk, quant=""):
    ids, labels = _batch()
    jenv.reset()
    mesh = jenv.build_mesh({"dp": n})
    jenv.set_mesh(mesh)
    try:
        paddle.seed(0)
        jm = JModel(JConfig(**TINY, scan_layers=True))
        for name, p in jm.named_parameters():
            p._data = jnp.asarray(named[name])
        jm.train()
        out = {p.name for name, p in jm.named_parameters()
               if _excluded(name)}
        opt = popt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP),
                         apply_decay_param_fun=lambda nm: nm not in out)
        step = JSharded(jm, opt, criterion=JCrit(), mesh=mesh, axis="dp",
                        layer_chunk=chunk, param_storage="replicated",
                        guard_nonfinite=True, numerics=False,
                        comm_quant=quant)
        t_ids = paddle.to_tensor(ids, dtype="int64")
        t_lab = paddle.to_tensor(labels, dtype="int64")
        losses = [float(step(t_ids, t_lab)) for _ in range(STEPS)]
        params = {name: np.asarray(p._data)
                  for name, p in jm.named_parameters()}
    finally:
        jenv.reset()
    return losses, params


@pytest.fixture(scope="module")
def named():
    return _weights()


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, named):
    """(n, the ranks' results, the reference's per chunk)."""
    n = request.param
    ids, labels = _batch()
    job = start("sharded_scan", n, dict(
        config=TINY, named=named, ids=ids, labels=labels, steps=STEPS,
        lr=LR, clip=CLIP, chunks=list(CHUNKS), dropout=True, quant="int8"),
        timeout=60)
    try:        # the reference, while the ranks run
        ref = {1: _jax_run(named, n, 1),
               "int8": _jax_run(named, n, 1, quant="int8")}
    finally:
        ranks = job.wait(deadline=150)
    return n, ranks, ref


@pytest.mark.parametrize("storage", ["replicated", "sharded"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_sharded_scan_matches_the_reference(world, storage, chunk):
    n, ranks, ref = world
    want_losses, want_params = ref[1]   # the reference's chunks agree
    tag = f"{storage}_{chunk}"
    for r, out in enumerate(ranks):
        got = out[f"losses_{tag}"]
        assert np.abs(got - np.asarray(want_losses)).max() < LOSS_BAR, \
            (r, got, want_losses)
        params = _as_ref(out[f"params_{tag}"])
        for name, want in want_params.items():
            assert _rel(params[name], want) < REL_BAR, (r, name)


@pytest.mark.parametrize("storage", ["replicated", "sharded"])
def test_comm_quant_int8_matches_the_reference(world, storage):
    """``comm_quant="int8"`` (the compressed scatter leg, and under the
    sharded storage the gather-on-use too): the losses within the
    reference's own comm-quant bar (relative 1e-2,
    ``comm_quant_selftest``) of the reference's quantized step and of the
    exact run. Quantization rounds grads that differ in the last bits to
    different int8 steps, so the two packages' quantized runs part by
    about as much as each parts from its exact run (measured 1.7e-3 in
    the loss at 2 ranks, against 6e-4 and 1.1e-3). Parameters are not
    held: a quantization step flips the sign of a small grad, which Adam
    turns into an lr-sized move (8.6e-2 of the embedding's largest after
    3 steps)."""
    n, ranks, ref = world
    for out in ranks:
        got = out[f"losses_quant_{storage}"]
        assert np.abs(got - out[f"losses_{storage}_1"]).max() > 0
        for want in (ref["int8"][0], ref[1][0]):
            want = np.asarray(want)
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-2


def test_the_storages_are_bit_identical_and_ranks_agree(world):
    n, ranks, _ = world
    for chunk in CHUNKS:
        rep, shd = f"replicated_{chunk}", f"sharded_{chunk}"
        for out in ranks:
            np.testing.assert_array_equal(out[f"losses_{rep}"],
                                          out[f"losses_{shd}"])
            for k, v in out[f"params_{rep}"].items():
                np.testing.assert_array_equal(v, out[f"params_{shd}"][k])
        for out in ranks[1:]:
            for k, v in out[f"params_{rep}"].items():
                np.testing.assert_array_equal(v, ranks[0][f"params_{rep}"][k])


def test_shards_live_at_one_over_n_and_the_storage_is_freed(world):
    n, ranks, _ = world
    L = TINY["num_layers"]
    buckets = ranks[0]["buckets"]
    for out in ranks:
        for chunk in CHUNKS:
            for storage in ("replicated", "sharded"):
                sh = out[f"shards_{storage}_{chunk}"]
                assert [s // L for s in sh["s"]] + sh["o"] == \
                    [b // n for b in buckets]
            assert out[f"freed_sharded_{chunk}"]
            assert not out[f"freed_replicated_{chunk}"]
            calls = out[f"calls_replicated_{chunk}"]
            # one reduce-scatter a bucket a layer, one outer; the clip's
            # and the loss's all-reduces
            assert calls["reduce_scatter"] == L + 1
            assert calls["all_reduce"] == 2
            assert out[f"calls_sharded_{chunk}"]["all_gather"] == 2 * L + 1
    assert all(b % n == 0 for b in buckets)


def test_clip_factor_parity_vs_eager_global_norm(world, named):
    """The sharded step's clip (one all-reduce of the shards' sums)
    against the port's eager TrainStep with ClipGradByGlobalNorm on the
    whole batch; the clip is active (a run without it differs)."""
    n, ranks, _ = world
    ids, labels = (torch.from_numpy(a) for a in _batch())
    crit = GPTPretrainingCriterion()
    runs = {}
    for clip in (CLIP, None):
        tm = _port_model(named)
        opt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                    grad_clip=None if clip is None
                    else ClipGradByGlobalNorm(clip),
                    apply_decay_param_fun=lambda nm: not _excluded(nm))
        step = TrainStep(tm, lambda m, a, b: crit(m(a), b), opt,
                         numerics=False)
        runs[clip] = np.asarray([float(step(ids, labels))
                                 for _ in range(STEPS)])
    assert np.abs(runs[CLIP] - runs[None]).max() > 1e-3
    got = ranks[0]["losses_replicated_1"]
    assert np.abs(got - runs[CLIP]).max() < LOSS_BAR


def test_dropout_masks_differ_across_ranks_and_repeat(world):
    n, ranks, _ = world
    for out in ranks:
        a, b = out["dropout_losses"]
        assert a == b
    assert len({float(out["dropout_losses"][0]) for out in ranks}) == n


def test_select_train_step_picks_by_degree(world, named):
    n, ranks, _ = world
    assert all(out["select"] == "ShardedFusedScanTrainStep"
               for out in ranks)
    # a dp x mp mesh over the world: the dp x mp step (mp 2)
    assert all(out["select_mp"] == ["ShardedFusedScanTrainStep", n, 2]
               for out in ranks)
    tenv.init_parallel_env(backend="gloo")
    try:
        crit = GPTPretrainingCriterion()
        tm = _port_model(named)
        opt = AdamW(learning_rate=LR, parameters=tm.parameters())
        assert type(select_train_step(tm, opt, criterion=crit)) is \
            FusedScanTrainStep
        # mp_axis at degree 1 is dropped, as the reference drops it
        assert type(select_train_step(tm, opt, criterion=crit,
                                      mp_axis="mp")) is FusedScanTrainStep
        assert ShardedFusedScanTrainStep(
            tm, opt, criterion=crit, mp_axis="mp").mp_group is None
        flat = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
        assert type(select_train_step(
            flat, AdamW(parameters=flat.parameters()),
            criterion=crit)) is TrainStep
        for kw, item in ((dict(auto=True), "A9b"),
                         (dict(ep_axis="ep"), r"A9b\.3b")):
            with pytest.raises(NotImplementedError, match=item):
                select_train_step(tm, opt, criterion=crit, **kw)
        with pytest.raises(NotImplementedError, match=r"A9b\.3b"):
            ShardedFusedScanTrainStep(tm, opt, criterion=crit,
                                      ep_axis="ep")
        # a pp mesh is the pipelined step's (jit.PipelineScanTrainStep)
        pp = tenv.RankMesh({"pp": 2, "dp": 1})
        with pytest.raises(ValueError, match="PipelineScanTrainStep"):
            ShardedFusedScanTrainStep(tm, opt, criterion=crit, mesh=pp)
    finally:
        tenv.reset()
