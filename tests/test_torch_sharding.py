"""Sharding stages 1 and 2 of the port (`DygraphShardingOptimizer`,
`group_sharded_parallel`, ``fleet.distributed_optimizer``), in 2 and 4
gloo ranks on the CPU, against the JAX package's stages on a CPU mesh of
the same degree and against the port's single-process `TrainStep`.

A tiny GPT (2 layers, hidden 64, dropout 0; numpy weights from a seed,
carried by `convert`) trains 3 steps through `jit.TrainStep` with AdamW,
``ClipGradByGlobalNorm(1.0)``, the LayerNorms and biases out of the
decay, and the guard; the global batch (8 x 12) is split on dim 0, rank
r taking block r. The ranks run `paddle_tpu_torch.distributed.
sharding_selftest` (no jax), one launch a degree, under the launcher's
deadline. Bars: the losses within rtol 1e-5 of both, the reference's own
bar for its stages (tests/test_distributed.py:311,418-420). Parameters:
against the port's single process within 1e-4 of each tensor's largest
element (the reference's rtol 1e-4, taken over the tensor: elementwise,
rtol 1e-4 / atol 1e-5 misses one element of the 16384 of an
``fc1.weight`` by 1.9e-5 after 3 steps, measured 4.6e-5 of the tensor's
largest, because the ranks' sum adds the grads in another order than one
process does and Adam turns that rounding of a small grad into a larger
move); against the JAX stages ROADMAP's cross-package training bar,
5e-3 of each tensor's largest (the port's single-process step itself
misses the elementwise bar against the JAX plain step in the same way).
Also: each rank holds ceil(padded / n) elements of moments;
under stage 2 no full grad outlives ``apply_collective_grads``; an inf
on one rank only makes every rank skip, bit for bit; the excluded
parameters are not decayed; the optimizer state round-trips through
``framework/io.py``; a tiny BERT trains with stage 1 through
``fleet.distributed_optimizer`` as one process on the whole batch does.

The keys' bias (the middle third of each ``qkv.bias``) is left out of the
parameter bars: softmax ignores a constant added to a row's scores, so
its gradient is 0 up to rounding, and Adam moves it by about lr a step
whatever that rounding is (as tests/test_torch_bert.py sets out); the
loss bars cover it.
"""
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.sharding import group_sharded_parallel as jgsp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.sharding_selftest import start, unrolled
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertConfig,
                                     BertForSequenceClassification,
                                     GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, CrossEntropyLoss
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2,
            num_attention_heads=2, max_position_embeddings=16,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
BERT = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
STEPS, LR = 3, 1e-2
BERT_LR = 1e-3          # a fine-tuning rate
RUNS = ("stage1", "stage2", "fleet")


def _excluded(name):
    return "ln" in name or name.endswith("bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _bar_part(name, a):
    """``a`` without the keys' bias (see the module docstring)."""
    if name.endswith("qkv.bias"):
        h = a.shape[0] // 3
        return np.concatenate([a[:h], a[2 * h:]])
    return a


def _weights(seed=0):
    paddle.seed(0)
    jm = JModel(JConfig(**TINY))
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


def _bert():
    torch.manual_seed(0)
    m = BertForSequenceClassification(BertConfig(**BERT), num_classes=3,
                                      device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, BERT["vocab_size"], (8, 16))
    mask = np.ones((8, 16), np.int64)
    mask[::3, 10:] = 0
    return dict(config=BERT, steps=STEPS, lr=BERT_LR, ids=ids, mask=mask,
                labels=rng.integers(0, 3, (8,)),
                state={k: v.numpy().copy() for k, v in
                       m.state_dict().items()})


def _port_model(named):
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    tm.train()
    return tm


def _as_ref(params):
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    return convert.state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in params.items()}, model=tm)


def _jax_run(named, n, level):
    ids, labels = _batch()
    jenv.reset()
    mesh = jenv.build_mesh({"sharding": n})
    jenv.set_mesh(mesh)
    try:
        paddle.seed(0)
        jm = JModel(JConfig(**TINY))
        for name, p in jm.named_parameters():
            p._data = jnp.asarray(named[name])
        jm.train()
        out = {p.name for name, p in jm.named_parameters()
               if _excluded(name)}
        opt = popt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(1.0),
                         apply_decay_param_fun=lambda nm: nm not in out)
        model, opt, _ = jgsp(jm, opt, level=level)
        crit = JCrit()
        step = JTrainStep(model, lambda m, a, b: crit(m(a), b), opt,
                          guard_nonfinite=True, numerics=False)
        t_ids = paddle.to_tensor(ids, dtype="int64")
        t_lab = paddle.to_tensor(labels, dtype="int64")
        losses = [float(step(t_ids, t_lab)) for _ in range(STEPS)]
        params = {name: np.asarray(p._data)
                  for name, p in jm.named_parameters()}
    finally:
        jenv.reset()
    return np.asarray(losses), params


@pytest.fixture(scope="module")
def named():
    return _weights()


@pytest.fixture(scope="module")
def alone(named):
    """The port's single-process TrainStep on the whole batch."""
    tm = _port_model(named)
    crit = GPTPretrainingCriterion()
    opt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda nm: not _excluded(nm))
    step = TrainStep(tm, lambda m, a, b: crit(m(a), b), opt,
                     guard_nonfinite=True)
    ids, labels = (torch.from_numpy(a) for a in _batch())
    losses = np.asarray([float(step(ids, labels)) for _ in range(STEPS)])
    return losses, {k: v.numpy() for k, v in tm.state_dict().items()}, opt


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, named):
    n = request.param
    ids, labels = _batch()
    job = start("sharding", n, dict(
        config=TINY, named=unrolled(named, TINY["num_layers"]), ids=ids,
        labels=labels, steps=STEPS, runs=list(RUNS), bert=_bert()),
        timeout=60)
    try:        # the reference, while the ranks run
        ref = {lv: _jax_run(named, n, lv) for lv in ("os", "os_g")}
    finally:
        ranks = job.wait(deadline=150)
    return n, ranks, ref


@pytest.mark.parametrize("run", RUNS)
def test_stages_match_the_reference_and_one_process(world, alone, run):
    n, ranks, ref = world
    want_losses, want_params = ref["os_g" if run == "stage2" else "os"]
    one_losses, one_params, _ = alone
    for out in ranks:
        got = out[run]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        np.testing.assert_allclose(got["losses"], one_losses, rtol=1e-5)
        params = _as_ref(got["params"])
        for name, want in want_params.items():
            assert _rel(_bar_part(name, params[name]),
                        _bar_part(name, want)) < 5e-3, name
        for name, want in one_params.items():
            assert _rel(_bar_part(name, got["params"][name]),
                        _bar_part(name, want)) < 1e-4, name


def test_each_rank_holds_its_shard_only(world):
    n, ranks, _ = world
    for out in ranks:
        for run in RUNS:
            got = out[run]
            for numels, padded in zip(got["state_numel"],
                                      got["bucket_numel"]):
                assert padded % n == 0
                assert all(k == -(-padded // n) for k in numels)
    for out in ranks:
        got = out["stage2"]
        assert got["grads_after_sync"] == 0
        assert got["grad_shard_numel"] == [b // n for b in
                                           got["bucket_numel"]]
        # one reduce-scatter a bucket a step, no all-reduce of grads
        assert got["calls"]["reduce_scatter"] == len(got["bucket_numel"]) \
            * (STEPS + 1)


def test_the_monitor_grad_rows_come_from_the_shards(world):
    """Under a sharded optimizer `TrainStep`'s numerics rows take each
    parameter's grad norm from the ranks' shards and one all-reduce:
    equal to the whole batch's grads in one process."""
    n, ranks, _ = world
    for out in ranks:
        np.testing.assert_allclose(out["stage1"]["grad_sq_sharded"],
                                   out["stage1"]["grad_sq_whole"],
                                   rtol=1e-5, atol=1e-12)


def test_an_inf_on_one_rank_skips_every_rank(world):
    n, ranks, _ = world
    for out in ranks:
        for run in RUNS:
            got = out[run]
            assert not got["inf_loss_finite"]
            assert got["inf_skipped"]
            assert got["inf_step_count"] == got["step_count"] == STEPS


def test_excluded_parameters_are_not_decayed(world, alone):
    """AdamW's excluded LayerNorms and biases keep their own decay (0)
    inside the shards: their moments and values equal the single
    process's, whose per-parameter rule is the reference's."""
    n, ranks, _ = world
    _, one_params, one_opt = alone
    want_m1 = {one_opt._key(p): one_opt._accumulators["moment1"][p]
               .numpy() for p in one_opt._parameter_list}
    for out in ranks:
        got = out["stage1"]
        for k, v in got["moment1"].items():
            np.testing.assert_allclose(_bar_part(k, v),
                                       _bar_part(k, want_m1[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for k in got["params"]:
            if _excluded(k):
                np.testing.assert_allclose(
                    _bar_part(k, got["params"][k]),
                    _bar_part(k, one_params[k]), rtol=1e-5, atol=1e-7)


def test_state_dict_round_trips_through_framework_io(world):
    """Also `save_group_sharded_model` (stage 2): rank 0 writes the
    model and the gathered optimizer state, which the reference's
    ``paddle.load`` reads back equal to what rank 0 holds."""
    n, ranks, _ = world
    saved = os.path.join(ranks[0]["dir"], "saved")
    params = paddle.load(os.path.join(saved, "model.pdparams"))
    for k, v in ranks[0]["stage2"]["params_before_inf"].items():
        np.testing.assert_array_equal(params[k].numpy(), v)
    opt = paddle.load(os.path.join(saved, "model.pdopt"))
    assert opt["step"] == STEPS
    for k, v in ranks[0]["stage2"]["moment1"].items():
        got = opt["accumulators"]["moment1"][k]
        np.testing.assert_array_equal(getattr(got, "numpy", lambda: got)(),
                                      v)
    for out in ranks:
        for run in RUNS:
            assert out[run]["state_roundtrip"]
    for out in ranks[1:]:
        for k, v in out["stage1"]["moment1"].items():
            np.testing.assert_array_equal(v, ranks[0]["stage1"]["moment1"][k])


def test_bert_with_stage1_through_fleet_trains_as_one_process(world):
    n, ranks, _ = world
    b = _bert()
    m = BertForSequenceClassification(BertConfig(**BERT), num_classes=3,
                                      device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in b["state"].items()})
    m.train()
    crit = CrossEntropyLoss()
    step = TrainStep(m, lambda mm, i, k, y: crit(mm(i, attention_mask=k), y),
                     AdamW(learning_rate=BERT_LR, parameters=m.parameters()))
    batch = [torch.from_numpy(b[k]) for k in ("ids", "mask", "labels")]
    losses = np.asarray([float(step(*batch)) for _ in range(STEPS)])
    for out in ranks:
        np.testing.assert_allclose(out["bert"]["losses"], losses, rtol=1e-5)
        for k, v in m.state_dict().items():
            assert _rel(_bar_part(k, out["bert"]["params"][k]),
                        _bar_part(k, v.numpy())) < 1e-4, k
