"""Sharding stage 3 of the port (`GroupShardedStage3`,
``group_sharded_parallel(level="p_g_os")``), in 2 and 4 gloo ranks on the
CPU, against the JAX package's `GroupShardedStage3` + `TrainStep` on a
CPU mesh of the same degree and against the port's single-process
`TrainStep`.

The ranks run `paddle_tpu_torch.distributed.sharding_selftest`'s
``stage3`` case (no jax), one launch a degree, while this process
computes the reference; the global batch is split on dim 0, rank r
taking block r.

* The reference's own case (tests/test_distributed.py:429-470): an
  ``nn.Linear(16, 8)`` at ``segment_size=0``, AdamW(0.01), 3 `TrainStep`s
  of a squared error: the loss within rtol 1e-5, the weights within rtol
  1e-4 / atol 1e-5; its parameters hold no storage between steps.
* A tiny GPT (2 layers, hidden 64, non-scan, the head tied to ``wte``,
  recompute on; numpy weights from a seed carried by `convert`): AdamW
  with ``ClipGradByGlobalNorm(1.0)`` and the LayerNorms and biases out of
  the decay, the guard, ``model.loss`` (the fused head, which reads
  ``wte.weight`` outside ``wte``'s forward), ``segment_size`` 1024 bytes
  (the Linear and embedding weights and ``fc1``'s bias sharded, the rest
  whole): 3 steps within loss |diff| < 5e-4 and parameters relative <
  5e-3 of the reference's (ROADMAP's cross-package training bars); the
  same under ``amp.decorate(level="O2")`` (bf16 weights, fp32 masters)
  at lr 1e-3, loss within 5e-4 and the bf16 parameters within 1e-2
  relative in norm (tests/test_torch_llama.py's masters bar: one bf16
  ulp is 3.9e-3 of a value, and at lr 1e-2 the reference's bf16 stage
  3 parts from its own plain step by 5e-3 in loss by step 3, measured);
  ``accumulate_steps=2`` (each
  micro-batch's grads scattered as they complete) against the
  reference's at the fp32 bars; ``offload=True`` bit for bit the plain
  run (on the CPU offload changes nothing, as in the reference).
* What a rank holds between steps: each parameter of 1024 bytes or more
  no storage, the rest whole; the resident parameter bytes are the
  shards (at most 1/N of the sharded bytes plus a bucket's padding) plus
  the small parameters, equal on every step; `state_dict` leaves it so.
* `get_all_parameters(convert2cpu=True)` gives the whole values and
  touches nothing; `get_all_parameters()` gathers every parameter whole
  (the same values) and `reshard()` gives the shards back; a forward
  under ``no_grad`` and `load_state_dict` leave the shards alone; the
  wrapper's ``train_step`` is a `TrainStep` over the sharded optimizer.
* ``save_group_sharded_model``: the file, read with
  ``paddle_tpu_torch.load``, holds the ranks' gathered state and matches
  the port's single process trained on the whole batch (1e-4 of each
  tensor's largest, as tests/test_torch_sharding.py holds stage 2).
* ``offload=True`` at "os" / "os_g" is accepted and ignored.
* Sharding 2 x mp 2 (4 ranks, ``stage3_mp``): the port's GPT runs its mp
  blocks in the sharded scan step alone, so the composition with mp is
  held on the port's eager Megatron model, a tiny LLaMA (tied head,
  recompute): its mp blocks sharded further over the sharding group,
  against the reference's LLaMA placed by its ``llama_sharding_rules``
  on a ``{"sharding": 2, "mp": 2}`` mesh under its `GroupShardedStage3`
  (loss 5e-4, parameters 5e-3).

The keys' bias (the middle third of each ``qkv.bias``) is left out of the
GPT's parameter bars (tests/test_torch_sharding.py says why).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.amp import decorate as jdecorate
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.sharding import group_sharded_parallel as jgsp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import LlamaPretrainingCriterion as JLlamaCrit
from paddle_tpu.models.gpt import match_sharding as jmatch
from paddle_tpu.models.llama import (
    llama_sharding_rules as jllama_sharding_rules)
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.sharding_selftest import start
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=64, num_layers=2,
            num_attention_heads=2, max_position_embeddings=16,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=32, intermediate_size=48,
             use_recompute=True)
STEPS, LR, SEGMENT = 3, 1e-2, 1024
O2_LR = 1e-3        # bf16 at 1e-2 parts the reference from itself (below)
LOSS_BAR, REL_BAR = 5e-4, 5e-3
BF16_REL_BAR = 1e-2
LLAMA_LR, LLAMA_CLIP, LLAMA_EPS = 1e-2, 0.1, 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _bar_part(name, a):
    if name.endswith("qkv.bias"):
        h = a.shape[0] // 3
        return np.concatenate([a[:h], a[2 * h:]])
    return a


def _excluded(name):
    return "ln" in name or name.endswith("bias")


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


def _linear():
    rng = np.random.default_rng(3)
    return {"lin_w": (rng.standard_normal((16, 8)) * 0.3).astype(np.float32),
            "lin_b": (rng.standard_normal(8) * 0.1).astype(np.float32),
            "lin_x": np.random.RandomState(3).randn(8, 16).astype(np.float32),
            "lin_y": np.random.RandomState(4).randn(8, 8).astype(np.float32)}


def _jax_mesh(n):
    jenv.reset()
    mesh = jenv.build_mesh({"sharding": n})
    jenv.set_mesh(mesh)
    return mesh


def _jax_linear(a, n):
    _jax_mesh(n)
    try:
        m = jnn.Linear(16, 8)
        m.weight._data = jnp.asarray(a["lin_w"])
        m.bias._data = jnp.asarray(a["lin_b"])
        opt = popt.AdamW(learning_rate=0.01, parameters=m.parameters())
        mw, opt, _ = jgsp(m, opt, level="p_g_os", segment_size=0)
        x, y = (paddle.to_tensor(a[k]) for k in ("lin_x", "lin_y"))

        def lf(mm, xx, yy):
            d = mm(xx) - yy
            return (d * d).mean()

        step = JTrainStep(mw, lf, opt)
        losses = [float(step(x, y)) for _ in range(3)]
        return (np.asarray(losses), np.asarray(m.weight._data),
                np.asarray(m.bias._data))
    finally:
        jenv.reset()


def _jax_gpt(named, n, o2=False, accumulate=1):
    ids, labels = _batch()
    _jax_mesh(n)
    try:
        paddle.seed(0)
        jm = JModel(JConfig(**TINY, use_recompute=True))
        for name, p in jm.named_parameters():
            p._data = jnp.asarray(named[name])
        jm.train()
        out = {p.name for name, p in jm.named_parameters()
               if _excluded(name)}
        opt = popt.AdamW(learning_rate=O2_LR if o2 else LR,
                         parameters=jm.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(1.0),
                         apply_decay_param_fun=lambda nm: nm not in out)
        if o2:
            jdecorate(models=jm, optimizers=opt, level="O2")
        model, opt, _ = jgsp(jm, opt, level="p_g_os", segment_size=SEGMENT)
        crit = JCrit()
        step = JTrainStep(model, lambda m, a, b: crit(m(a), b), opt,
                          accumulate_steps=accumulate,
                          guard_nonfinite=True, numerics=False)
        t_ids = paddle.to_tensor(ids, dtype="int64")
        t_lab = paddle.to_tensor(labels, dtype="int64")
        losses = [float(step(t_ids, t_lab)) for _ in range(STEPS)]
        params = {name: np.asarray(p._data.astype(jnp.float32))
                  for name, p in jm.named_parameters()}
    finally:
        jenv.reset()
    return np.asarray(losses), params


def _as_ref(params):
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    return convert.state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in params.items()}, model=tm)


@pytest.fixture(scope="module")
def named():
    return _weights()


@pytest.fixture(scope="module")
def alone(named):
    """The port's single-process TrainStep on the whole batch (fp32)."""
    tm = GPTForCausalLM(GPTConfig(**TINY, use_recompute=True), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    tm.train()
    opt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda nm: not _excluded(nm))
    step = TrainStep(tm, lambda m, a, b: m.loss(a, b), opt,
                     guard_nonfinite=True)
    ids, labels = (torch.from_numpy(a) for a in _batch())
    losses = np.asarray([float(step(ids, labels)) for _ in range(STEPS)])
    return losses, {k: v.numpy() for k, v in tm.state_dict().items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, named):
    n = request.param
    ids, labels = _batch()
    lin = _linear()
    job = start("stage3", n, dict(
        config=TINY, named=named, ids=ids, labels=labels, steps=STEPS,
        lr=LR, o2_lr=O2_LR, segment=SEGMENT, **lin), timeout=60)
    try:        # the reference, while the ranks run
        ref = {"linear": _jax_linear(lin, n),
               "fp32": _jax_gpt(named, n),
               "o2": _jax_gpt(named, n, o2=True),
               "accumulate": _jax_gpt(named, n, accumulate=2)}
    finally:
        ranks = job.wait(deadline=200)
    return n, ranks, ref


def test_the_reference_linear_case(world):
    n, ranks, ref = world
    losses, w, b = ref["linear"]
    for out in ranks:
        got = out["linear"]
        assert got["type"] == "GroupShardedStage3"
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["weight"], w, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["bias"], b, rtol=1e-4, atol=1e-5)
        assert got["storage"] == [0, 0]        # sharded between steps


@pytest.mark.parametrize("run,bars", [
    ("fp32", (LOSS_BAR, REL_BAR)), ("o2", (LOSS_BAR, BF16_REL_BAR)),
    ("accumulate", (LOSS_BAR, REL_BAR))])
def test_tiny_gpt_matches_the_reference(world, run, bars):
    n, ranks, ref = world
    want_losses, want_params = ref[run]
    for out in ranks:
        got = out[run]
        gap = np.abs(got["losses"] - want_losses).max()
        assert gap < bars[0], (got["losses"], want_losses)
        mine = _as_ref(got["params"])
        assert set(mine) == set(want_params)
        for k, v in want_params.items():
            a, b = _bar_part(k, mine[k]), _bar_part(k, v)
            gap = (_rel(a, b) if run != "o2" else float(
                np.linalg.norm(a - b) / np.linalg.norm(b)))
            assert gap < bars[1], k
    # every rank holds the same whole values
    for out in ranks[1:]:
        for k, v in out[run]["params"].items():
            np.testing.assert_array_equal(v, ranks[0][run]["params"][k])


def test_offload_is_bit_identical_on_the_cpu(world):
    n, ranks, _ = world
    for out in ranks:
        np.testing.assert_array_equal(out["offload"]["losses"],
                                      out["fp32"]["losses"])
        for k, v in out["fp32"]["params"].items():
            np.testing.assert_array_equal(out["offload"]["params"][k], v)


def test_segment_size_threshold_and_resident_bytes(world):
    """Parameters of 1024 bytes or more hold no storage between steps;
    the rank's resident parameter bytes are its shards plus the small
    parameters: at most 1/N of the sharded bytes (plus a bucket's
    padding, under one element of it a bucket) plus the small ones."""
    n, ranks, _ = world
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    sizes = {k: p.numel() * 4 for k, p in tm.named_parameters()}
    big = {k for k, b in sizes.items() if b >= SEGMENT}
    assert {"gpt.wte.weight", "gpt.blocks.0.mlp.fc1.bias"} <= big
    assert "gpt.blocks.0.attn.qkv.bias" not in big
    sharded = sum(sizes[k] for k in big)
    small = sum(b for k, b in sizes.items() if k not in big)
    for out in ranks:
        got = out["fp32"]
        for k, nbytes in got["storage"].items():
            assert (nbytes == 0) == (k in big), k
        shards = 4 * sum(got["shard_numel"])
        assert shards <= sharded / n + 4 * len(got["shard_numel"])
        assert got["resident"] == [shards + small] * STEPS
        assert got["resident_after_state_dict"] == shards + small
        assert got["full_bytes"] == sharded + small
        assert got["resident"][0] < got["full_bytes"] / n + small


def test_get_all_parameters_and_reshard(world):
    n, ranks, _ = world
    for out in ranks:
        got = out["fp32"]
        assert got["step"] == ["TrainStep", "DygraphShardingOptimizer"]
        full = got["full_bytes"]
        assert got["resident_after_cpu"] == got["resident"][-1]
        for k, v in got["gathered"].items():
            np.testing.assert_array_equal(got["cpu_copies"][k], v)
            np.testing.assert_array_equal(v, got["params"][k])
        assert got["resident_gathered"] >= full
        assert got["resident_resharded"] == got["resident"][-1]


def test_eval_forward_and_state_dict_load(world):
    """A forward under ``no_grad`` leaves only the shards (the same
    logits on every rank); whole values loaded back come out bit for bit
    and leave the shards."""
    n, ranks, _ = world
    for out in ranks:
        got = out["fp32"]
        np.testing.assert_array_equal(got["eval_logits"],
                                      ranks[0]["fp32"]["eval_logits"])
        assert got["resident_after_eval"] == got["resident"][-1]
        assert got["reloaded"]
        assert got["resident_after_load"] == got["resident"][-1]


def test_saved_file_is_the_world_of_one_s(world, alone):
    n, ranks, _ = world
    _, want = alone
    saved = pt.load(f"{ranks[0]['dir']}/stage3/model.pdparams")
    assert set(saved) == set(want)
    for k, v in saved.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(v, ranks[0]["fp32"]["params"][k])
        assert _rel(_bar_part(k, v), _bar_part(k, want[k])) < 1e-4, k


def test_offload_accepted_and_ignored_at_os_and_os_g(world):
    n, ranks, _ = world
    for out in ranks:
        acc = out["offload_accepted"]
        assert set(acc) == {"os", "os_g"}
        assert all(np.isfinite(v) for v in acc.values())
        assert acc["os"] == acc["os_g"]


# -- sharding 2 x mp 2 -------------------------------------------------------

def _llama_named():
    paddle.seed(0)
    jm = JLlama(JLlamaConfig(**LLAMA))
    rng = np.random.default_rng(2)
    out = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        out[name] = 1.0 + 0.1 * a if p.ndim == 1 else 0.1 * a
    return out


def _jax_llama(a):
    devs = np.array(jax.devices("cpu")[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("sharding", "mp"))
    jenv.reset()
    jenv.set_mesh(mesh)
    try:
        paddle.seed(0)
        jm = JLlama(JLlamaConfig(**LLAMA))
        rules = jllama_sharding_rules(tp_axis="mp")
        for name, p in jm.named_parameters():
            p._data = jnp.asarray(a["named"][name])
            spec = jmatch(name, rules) or ()
            axes = [ax if (ax and p._data.shape[i] % mesh.shape[ax] == 0)
                    else None for i, ax in enumerate(spec)]
            p._data = jax.device_put(
                p._data, NamedSharding(mesh, P(*axes) if axes else P()))
        jm.train()
        opt = popt.AdamW(learning_rate=LLAMA_LR, epsilon=LLAMA_EPS,
                         weight_decay=0.01, parameters=jm.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(LLAMA_CLIP))
        model, opt, _ = jgsp(jm, opt, level="p_g_os", segment_size=SEGMENT)
        crit = JLlamaCrit()
        step = JTrainStep(model, lambda m, i, l: crit(m(i), l), opt)
        ids, labels = (paddle.to_tensor(a[k], dtype="int64")
                       for k in ("ids", "labels"))
        losses = [float(step(ids, labels)) for _ in range(STEPS)]
        params = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        return np.asarray(losses), params
    finally:
        jenv.reset()


@pytest.fixture(scope="module")
def mp_world():
    rng = np.random.default_rng(1)
    a = {"config": LLAMA, "named": _llama_named(), "mp": 2,
         "steps": STEPS, "lr": LLAMA_LR, "clip": LLAMA_CLIP,
         "eps": LLAMA_EPS, "segment": SEGMENT,
         "ids": rng.integers(0, 64, (4, 16)),
         "labels": rng.integers(0, 64, (4, 16))}
    job = start("stage3_mp", 4, a, timeout=60)
    try:
        ref = _jax_llama(a)
    finally:
        ranks = job.wait(deadline=200)
    return ranks, ref


def test_sharding_2_x_mp_2_matches_the_placed_reference(mp_world):
    from types import SimpleNamespace

    ranks, (want_losses, want_params) = mp_world
    for out in ranks:
        assert out["groups"] == [2, 2]
        gap = np.abs(out["losses"] - want_losses).max()
        assert gap < LOSS_BAR, (out["losses"], want_losses)
        assert out["resident"] < out["full_bytes"]
    by = {tuple(o["coords"]): o["state"] for o in ranks}
    for (s, r), st in by.items():       # the sharding ranks agree
        for k, v in st.items():
            np.testing.assert_array_equal(v, by[(0, r)][k], err_msg=k)
    model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu",
                             mp_group=SimpleNamespace(nranks=2, rank=0))
    joined = convert.mp_state_dict_to_jax(
        [{k: torch.from_numpy(v) for k, v in by[(0, r)].items()}
         for r in range(2)], model)
    assert set(joined) == set(want_params)
    for k, v in want_params.items():
        assert _rel(joined[k], v) < REL_BAR, k
