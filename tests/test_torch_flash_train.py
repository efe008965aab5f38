"""GPT training through the flash routing (``FLAGS_splash_attn`` off) of
the PyTorch port against the JAX package.

Both packages run with the splash flag off and
``FLAGS_pallas_flash_min_seqlen`` lowered to 16, the reference also with
``FLAGS_fused_ce`` on, so that its attention at 64 tokens takes the Pallas
flash kernels in interpret mode (the tests assert that it did), as the
port's takes its flash entries (their plain versions on CPU tensors): the
single-block pair, since 64 <= 1024. The tiled pair is held at kernel level in
tests/test_torch_flash_attention.py (a model above 1024 tokens is too slow
in interpret mode). Weights are drawn with numpy from a seed and carried
across by `convert.state_dict_from_jax`. Bars, as in
tests/test_torch_train.py: the loss within 1e-5 and every gradient within
1e-4 of its largest magnitude; 3 `TrainStep`s (AdamW, clip 1.0) with loss
|diff| < 5e-4 each step and parameters relative < 5e-3 at the end (the
reference's own bars, tests/test_training_kernels.py).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.utils import flags as jflags
import paddle_tpu_torch
from paddle_tpu_torch import convert
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
JAX_FLAGS = {"FLAGS_splash_attn": False, "FLAGS_fused_ce": True,
             "FLAGS_pallas_flash_min_seqlen": 16}
PORT_FLAGS = {"FLAGS_splash_attn": False,
              "FLAGS_pallas_flash_min_seqlen": 16}


@pytest.fixture
def flash_routing(monkeypatch):
    """Both packages on the flash routing; counts the reference's flash
    calls (at trace time) and the port's single-block forwards."""
    saved_j = {n: jflags.get_flag(n) for n in JAX_FLAGS}
    saved_t = paddle_tpu_torch.get_flags(list(PORT_FLAGS))
    jflags.set_flags(JAX_FLAGS)
    paddle_tpu_torch.set_flags(PORT_FLAGS)
    calls = {"jax": 0, "port": 0}
    jorig, torig = jfa.flash_attention, fa.flash_attention_single_ref

    def jspy(*a, **kw):
        calls["jax"] += 1
        return jorig(*a, **kw)

    def tspy(*a, **kw):
        calls["port"] += 1
        return torig(*a, **kw)

    monkeypatch.setattr(jfa, "flash_attention", jspy)
    monkeypatch.setattr(fa, "flash_attention_single_ref", tspy)
    yield calls
    jflags.set_flags(saved_j)
    paddle_tpu_torch.set_flags(saved_t)


def make_models(seed=0, **over):
    cfg = {**TINY, **over}
    paddle.seed(0)
    jm = JModel(JConfig(**cfg))
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if name.endswith("bias"):
            a *= 0.05
        elif p.ndim == 1:                        # LayerNorm scale
            a = 1.0 + 0.1 * a
        else:
            a *= 0.1
        p._data = jnp.asarray(a)
        named[name] = a
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named))
    jm.train()
    tm.train()
    return jm, tm


def _batch(b=2, s=64, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (b, s))
    labels = rng.integers(0, TINY["vocab_size"], (b, s))
    labels[0, ::7] = -100
    return ids, labels


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("recompute", [False, True])
def test_loss_and_grads_match_jax(flash_routing, recompute):
    jm, tm = make_models(use_recompute=recompute)
    ids, labels = _batch()
    jl = jm.loss(paddle.to_tensor(ids, dtype="int64"),
                 paddle.to_tensor(labels, dtype="int64"))
    jl.backward()
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    assert flash_routing["jax"] >= TINY["num_layers"]
    # recompute runs each block's forward again in the backward
    assert flash_routing["port"] == TINY["num_layers"] * (1 + recompute)
    assert abs(tl.item() - float(jl)) < 1e-5
    jgrads = convert.state_dict_from_jax(
        {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()})
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[name].numpy()) < 1e-4, name


def test_train_step_trajectory_matches_jax(flash_routing):
    jm, tm = make_models(seed=2)
    ids, labels = _batch(b=4, seed=2)
    jopt = popt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                      parameters=jm.parameters(), grad_clip=JClip(1.0))
    jstep = JTrainStep(jm, lambda m, x, y: m.loss(x, y), jopt)
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, lambda m, x, y: m.loss(x, y), topt)
    ja = [paddle.to_tensor(x, dtype="int64") for x in (ids, labels)]
    ta = [torch.from_numpy(x) for x in (ids, labels)]
    jl = [float(jstep(*ja)) for _ in range(3)]
    tl = [float(tstep(*ta)) for _ in range(3)]
    assert flash_routing["jax"] >= TINY["num_layers"]
    assert flash_routing["port"] == 3 * TINY["num_layers"]
    assert max(abs(a - b) for a, b in zip(jl, tl)) < 5e-4, (jl, tl)
    assert tl[-1] < tl[0]
    want = {k: v.float().numpy() for k, v in convert.state_dict_from_jax(
        {n: np.asarray(p._data.astype(jnp.float32))
         for n, p in jm.named_parameters()}).items()}
    for name, p in tm.named_parameters():
        assert _rel(p.detach().numpy(), want[name]) < 5e-3, name
