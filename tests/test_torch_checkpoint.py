"""Checkpoint files between the JAX package and the PyTorch port
(`paddle_tpu_torch.save` / `load`, `convert`'s model and optimizer maps),
and the converter's repairs.

Files cross both ways: the JAX package's ``paddle.save`` writes, the
port's `load` reads and training continues in both; the port's `save`
writes, the JAX package's ``paddle.load`` reads bit for bit and its
optimizer continues. After every load the optimizer state (each
accumulator and master weight, the step, the learning rate and the
scheduler) is held bit for bit against the writer's. Bars for the
continued run: parameters relative < 5e-3 and, for fp32 computation,
loss |diff| < 5e-4 (the reference's own bars,
tests/test_training_kernels.py). bf16 weights compute in bf16, which the
two frameworks round at other places, so a bf16 run's losses drift
apart by up to 9.4e-4 over the 3 steps (printed under ``pytest -s``):
they are held to 2e-3. The ResNet
continuation starts each of its steps from a file the JAX package wrote
after the step before: a resnet18 trajectory at 32 x 32 and batch 4 is
chaotic (tests/test_torch_vision.py), so free-running steps would
measure the chaos. A subprocess with ``jax``, ``ml_dtypes`` and ``paddle_tpu``
blocked loads a reference file and writes one.
"""
import copy
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp
import ml_dtypes

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.vision.models import resnet18 as jresnet18
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.framework.io import Bfloat16Bits
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW, Momentum, lr as tlr
from paddle_tpu_torch.vision.models import resnet18

ROOT = Path(__file__).resolve().parents[1]
LOSS_BAR, REL_BAR = 5e-4, 5e-3
BF16_LOSS_BAR = 2e-3
TINY = dict(vocab_size=96, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _f32(t):
    return t.detach().float().numpy()


def _jnp(t):
    return np.asarray(t._data.astype(jnp.float32))


# ---------------------------------------------------------------------------
# GPT, bf16 weights with fp32 masters and bf16 moments, AdamW, a scheduler
# and a GradScaler
# ---------------------------------------------------------------------------

def _gpt_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, TINY["vocab_size"], (2, 32)),
             rng.integers(0, TINY["vocab_size"], (2, 32))) for _ in range(n)]


def _jax_gpt(tied=True, bf16=True):
    paddle.seed(0)
    jm = JModel(JConfig(**TINY, tie_word_embeddings=tied))
    rng = np.random.default_rng(0)
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        a = 1.0 + 0.1 * a if p.ndim == 1 and "ln" in name else 0.1 * a
        p._data = jnp.asarray(a)
    if bf16:
        jm.bfloat16()
    sched = popt.lr.StepDecay(learning_rate=1e-4, step_size=2, gamma=0.5)
    jopt = popt.AdamW(learning_rate=sched, parameters=jm.parameters(),
                      multi_precision=True, moment_dtype="bfloat16")
    jscaler = JScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    jstep = JTrainStep(jm, lambda m, x, y: m.loss(x, y), jopt,
                       scaler=jscaler)
    return jm, jopt, sched, jscaler, jstep


def _port_gpt(tied=True, bf16=True):
    tm = GPTForCausalLM(GPTConfig(**TINY, tie_word_embeddings=tied),
                        device="cpu")
    if bf16:
        tm.bfloat16()
    sched = tlr.StepDecay(learning_rate=1e-4, step_size=2, gamma=0.5)
    topt = AdamW(learning_rate=sched, parameters=tm.parameters(),
                 multi_precision=True, moment_dtype="bfloat16")
    tscaler = GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    tstep = TrainStep(tm, lambda m, x, y: m.loss(x, y), topt,
                      scaler=tscaler)
    return tm, topt, sched, tscaler, tstep


def _run_jax(jstep, batches):
    """The losses of ``batches``; each step also steps the scheduler."""
    return [float(jstep(paddle.to_tensor(ids, dtype="int64"),
                        paddle.to_tensor(labels, dtype="int64")))
            for ids, labels in batches]


def _run_port(tstep, batches):
    return [float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
            for ids, labels in batches]


def _params_rel(jm, tm):
    """{state-dict name: the port parameter's rel difference from the
    reference's}."""
    want = convert.state_dict_from_jax(
        {n: _jnp(p) for n, p in jm.named_parameters()}, model=tm)
    return {name: _rel(_f32(p), want[name].numpy())
            for name, p in tm.named_parameters()}



def _save_jax(path, jm, jopt, jscaler):
    paddle.save({"model": jm.state_dict(), "opt": jopt.state_dict(),
                 "scaler": jscaler.state_dict()}, path)


def _load_port(path, tm, topt, tscaler):
    ck = pt.load(path)
    tm.load_state_dict(convert.state_dict_from_jax(ck["model"], model=tm))
    topt.set_state_dict(convert.optimizer_state_from_jax(ck["opt"], tm,
                                                         topt))
    tscaler.load_state_dict(ck["scaler"])
    return ck


def _save_port(path, tm, topt, tscaler, jm):
    names = {n: p.name for n, p in jm.named_parameters()}
    pt.save({"model": convert.state_dict_to_jax(tm.state_dict(), model=tm,
                                                tensors=True),
             "opt": convert.optimizer_state_to_jax(topt.state_dict(), tm,
                                                   topt, names=names),
             "scaler": tscaler.state_dict()}, path)


def _load_jax(path, jm, jopt, jscaler):
    ck = paddle.load(path)
    jm.set_state_dict(ck["model"])
    jopt.set_state_dict(ck["opt"])
    jscaler.load_state_dict(ck["scaler"])
    return ck


def _bits(a):
    """An array's or tensor's raw bytes and dtype, for bit-for-bit
    comparison (bf16 through its 16-bit pattern)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return "bf16", a.view(torch.int16).numpy().tobytes()
        return str(a.numpy().dtype), a.numpy().tobytes()
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return "bf16", a.view(np.int16).tobytes()
    return str(a.dtype), a.tobytes()


def _assert_states_equal(jm, jopt, tm, topt):
    """The port's optimizer state equals the reference's bit for bit:
    every accumulator and master weight, looked up by the reference's
    ``p.name`` on one side and the port's parameter of the same
    state-dict name on the other (a Linear weight's state transposed by
    the test itself), the step count, the learning rate and the
    scheduler's state."""
    ref = jopt.state_dict()
    tparams = dict(tm.named_parameters())
    linear = {f"{n}.weight" for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    assert set(ref["accumulators"]) == set(topt._accumulators)
    for name, jp in jm.named_parameters():
        tp = tparams[name]
        pairs = [(store[jp.name], topt._accumulators[acc][tp])
                 for acc, store in ref["accumulators"].items()]
        assert (jp.name in ref["master_weights"]) == \
            (tp in topt._master_weights), name
        if jp.name in ref["master_weights"]:
            pairs.append((ref["master_weights"][jp.name],
                          topt._master_weights[tp]))
        for want, got in pairs:
            if name in linear:
                got = got.t()
            assert _bits(got) == _bits(want), name
    assert topt._step_count == ref["step"]
    assert topt.get_lr() == jopt.get_lr()
    if "LR_Scheduler" in ref:
        assert topt._learning_rate.state_dict() == ref["LR_Scheduler"]


def _assert_continued_runs_agree(jm, tm, jl, tl, bf16):
    gap = max(abs(a - b) for a, b in zip(jl, tl))
    name, rel = max(_params_rel(jm, tm).items(), key=lambda x: x[1])
    print(f"continued run: loss |diff| {gap!r}, params rel {rel!r}")
    assert gap < (BF16_LOSS_BAR if bf16 else LOSS_BAR), (jl, tl)
    assert rel < REL_BAR, (name, rel)


GPT_CASES = {"bf16 params, fp32 masters, bf16 moments, tied": (True, True),
             "bf16 params, fp32 masters, bf16 moments, untied": (False, True),
             "fp32 params, bf16 moments, tied": (True, False),
             "fp32 params, bf16 moments, untied": (False, False)}


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_reference_gpt_file_continues_in_the_port(tmp_path, case):
    """The JAX package trains 2 steps (AdamW with bf16 moments, a
    scheduler, a GradScaler) and writes model, optimizer and scaler; the
    port loads the file bit for bit, and both run 3 more steps."""
    tied, bf16 = GPT_CASES[case]
    jm, jopt, jsched, jscaler, jstep = _jax_gpt(tied, bf16)
    tm, topt, tsched, tscaler, tstep = _port_gpt(tied, bf16)
    batches = _gpt_batches(5)
    _run_jax(jstep, batches[:2])
    path = str(tmp_path / "gpt.pdparams")
    _save_jax(path, jm, jopt, jscaler)
    ck = _load_port(path, tm, topt, tscaler)
    assert all(t.dtype == torch.bfloat16
               for t in ck["opt"]["accumulators"]["moment1"].values())
    assert topt._step_count == 2 and tsched.last_epoch == jsched.last_epoch \
        == 2
    assert tscaler.get_loss_scaling() == jscaler.get_loss_scaling()
    assert tscaler.state_dict() == jscaler.state_dict()
    wte = tm.gpt.wte.weight
    jwte = dict(jm.named_parameters())["gpt.wte.weight"]
    assert np.array_equal(_f32(wte), _jnp(jwte))
    assert bool(topt._master_weights) == bf16
    _assert_states_equal(jm, jopt, tm, topt)

    jl = _run_jax(jstep, batches[2:])
    tl = _run_port(tstep, batches[2:])
    _assert_continued_runs_agree(jm, tm, jl, tl, bf16)
    assert tscaler.get_loss_scaling() == jscaler.get_loss_scaling()


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_port_gpt_file_reads_back_in_the_reference(tmp_path, case):
    """The port trains 2 steps and writes the reference's format; the JAX
    package's paddle.load reads every tensor and optimizer array bit for
    bit, and both continue 3 steps."""
    tied, bf16 = GPT_CASES[case]
    jm, jopt, jsched, jscaler, jstep = _jax_gpt(tied, bf16)
    tm, topt, tsched, tscaler, tstep = _port_gpt(tied, bf16)
    tm.load_state_dict(convert.state_dict_from_jax(
        {n: np.asarray(t._data) for n, t in jm.state_dict().items()},
        model=tm))
    batches = _gpt_batches(5, seed=2)
    _run_port(tstep, batches[:2])
    path = str(tmp_path / "port.pdparams")
    _save_port(path, tm, topt, tscaler, jm)
    ck = _load_jax(path, jm, jopt, jscaler)
    linear = convert.linear_weights(tm)
    for name, t in tm.state_dict().items():
        got = ck["model"][name]
        assert isinstance(got, paddle.Tensor)
        want = t.t() if name in linear else t
        assert np.array_equal(np.asarray(got._data.astype(jnp.float32)),
                              _f32(want)), name
    m1 = ck["opt"]["accumulators"]["moment1"]
    assert all(a.dtype == ml_dtypes.bfloat16 for a in m1.values())
    port_m1 = topt.state_dict()["accumulators"]["moment1"]
    jname = dict(jm.named_parameters())["gpt.wte.weight"].name
    assert np.array_equal(m1[jname].astype(np.float32),
                          _f32(port_m1[topt._key(tm.gpt.wte.weight)]))
    assert jopt._step_count == 2 and jsched.last_epoch == tsched.last_epoch \
        == 2
    assert jscaler.state_dict() == tscaler.state_dict()
    _assert_states_equal(jm, jopt, tm, topt)

    tl = _run_port(tstep, batches[2:])
    jl = _run_jax(jstep, batches[2:])
    _assert_continued_runs_agree(jm, tm, jl, tl, bf16)


def test_trainstep_steps_the_scheduler_as_the_reference():
    """The reference's step advances a host-side LRScheduler after each
    call (paddle_tpu/jit/train_step.py, end of ``__call__``); the port's
    did not, so a file's scheduler and every lr after it fell behind."""
    jm, jopt, jsched, jscaler, jstep = _jax_gpt(bf16=False)
    tm, topt, tsched, tscaler, tstep = _port_gpt(bf16=False)
    tm.load_state_dict(convert.state_dict_from_jax(
        {n: np.asarray(t._data) for n, t in jm.state_dict().items()},
        model=tm))
    for i, batch in enumerate(_gpt_batches(3, seed=3)):
        jl, tl = _run_jax(jstep, [batch]), _run_port(tstep, [batch])
        assert abs(jl[0] - tl[0]) < LOSS_BAR
        assert tsched.last_epoch == jsched.last_epoch == i + 1
        assert topt.get_lr() == jopt.get_lr()


# ---------------------------------------------------------------------------
# resnet18 with Momentum: BN buffers in the model file, counter keys whose
# order is not named_parameters() order
# ---------------------------------------------------------------------------

def test_reference_resnet_file_continues_in_the_port(tmp_path):
    paddle.seed(0)
    jm = jresnet18(num_classes=10)
    jcrit = paddle.nn.CrossEntropyLoss()
    jopt = popt.Momentum(learning_rate=0.1, momentum=0.9,
                         parameters=jm.parameters())
    jstep = JTrainStep(jm, lambda m, x, y: jcrit(m(x), y), jopt)
    tm = resnet18(num_classes=10, device="cpu")
    tcrit = pnn.CrossEntropyLoss()
    topt = Momentum(learning_rate=0.1, momentum=0.9,
                    parameters=tm.parameters())
    tstep = TrainStep(tm, lambda m, x, y: tcrit(m(x), y), topt)
    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
                rng.integers(0, 10, (4,))) for _ in range(5)]
    for x, y in batches[:2]:
        jstep(paddle.to_tensor(x), paddle.to_tensor(y, dtype="int64"))
    for i, (x, y) in enumerate(batches[2:]):
        path = str(tmp_path / f"resnet_{i}.pdparams")
        paddle.save({"model": jm.state_dict(), "opt": jopt.state_dict()},
                    path)
        ck = pt.load(path)
        assert "layer1.0.bn1._mean" in ck["model"]
        tm.load_state_dict(convert.state_dict_from_jax(ck["model"],
                                                       model=tm))
        topt.set_state_dict(convert.optimizer_state_from_jax(ck["opt"], tm,
                                                             topt))
        assert topt._step_count == 2 + i
        _assert_states_equal(jm, jopt, tm, topt)
        jl = float(jstep(paddle.to_tensor(x),
                         paddle.to_tensor(y, dtype="int64")))
        tl = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(jl - tl) < LOSS_BAR, (i, jl, tl)
        want = convert.state_dict_from_jax(
            {n: np.asarray(t._data) for n, t in jm.state_dict().items()},
            model=tm)
        for name, t in tm.state_dict().items():
            assert _rel(t, want[name]) < REL_BAR, (i, name)


def test_optimizer_map_orders_by_creation_not_by_name():
    """A downsample's velocity lands on the downsample: keys in counter
    rank order are parameters in creation order."""
    paddle.seed(0)
    jm = jresnet18(num_classes=10)
    tm = resnet18(num_classes=10, device="cpu")
    topt = Momentum(learning_rate=0.1, parameters=tm.parameters())
    state = {"accumulators": {"velocity": {
                 p.name: np.full(tuple(p.shape), i, np.float32)
                 for i, (n, p) in enumerate(jm.named_parameters())}},
             "master_weights": {}, "step": 4}
    mapped = convert.optimizer_state_from_jax(state, tm, topt)
    topt.set_state_dict(mapped)
    names = [n for n, _ in jm.named_parameters()]
    for i, (name, p) in enumerate(tm.named_parameters()):
        v = topt._accumulators["velocity"][p]
        want = names.index(name)
        if name == "fc.weight":
            assert tuple(v.shape) == tuple(p.shape)
        assert v.eq(want).all(), name
    back = convert.optimizer_state_to_jax(
        topt.state_dict(), tm, topt,
        names={n: p.name for n, p in jm.named_parameters()})
    for key, a in state["accumulators"]["velocity"].items():
        assert np.array_equal(back["accumulators"]["velocity"][key], a)
    del state["accumulators"]["velocity"][jm.fc.bias.name]
    with pytest.raises(ValueError, match="parameters"):
        convert.optimizer_state_from_jax(state, tm, topt)


def test_optimizer_map_survives_a_deep_copy_and_checks_shapes():
    """The map follows the model's structure: a deep-copied ResNet maps
    every velocity onto the parameter of the same name, both ways, and a
    state whose shape is not its parameter's raises with the name."""
    paddle.seed(0)
    jm = jresnet18(num_classes=10)
    tm = copy.deepcopy(resnet18(num_classes=10, device="cpu"))
    topt = Momentum(learning_rate=0.1, parameters=tm.parameters())
    names = {n: p.name for n, p in jm.named_parameters()}
    state = {"accumulators": {"velocity": {
                 p.name: np.full(tuple(p.shape), i, np.float32)
                 for i, (n, p) in enumerate(jm.named_parameters())}},
             "master_weights": {}, "step": 1}
    topt.set_state_dict(convert.optimizer_state_from_jax(state, tm, topt))
    jindex = {n: i for i, (n, _) in enumerate(jm.named_parameters())}
    for name, p in tm.named_parameters():
        assert topt._accumulators["velocity"][p].eq(jindex[name]).all(), \
            name
    back = convert.optimizer_state_to_jax(topt.state_dict(), tm, topt,
                                          names=names)
    for key, a in state["accumulators"]["velocity"].items():
        assert np.array_equal(back["accumulators"]["velocity"][key], a)
    bad = topt.state_dict()
    key = topt._key(tm.layer2[0].downsample[0].weight)
    bad["accumulators"]["velocity"][key] = torch.zeros(3)
    with pytest.raises(ValueError, match="layer2.0.downsample.0.weight"):
        convert.optimizer_state_to_jax(bad, tm, topt, names=names)


# ---------------------------------------------------------------------------
# the converter's repairs
# ---------------------------------------------------------------------------

def test_linear_weights_come_from_the_model_not_from_names():
    """A square Linear of any model is transposed when the model is
    given; a shape that still disagrees names the parameter."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(),
                                pnn.Linear(4, 3))
    rng = np.random.default_rng(9)
    ref = {"0.weight": rng.standard_normal((4, 4)).astype(np.float32),
           "0.bias": rng.standard_normal(4).astype(np.float32),
           "2.weight": rng.standard_normal((4, 3)).astype(np.float32),
           "2.bias": rng.standard_normal(3).astype(np.float32)}
    assert convert.linear_weights(model) == {"0.weight", "2.weight"}
    model.load_state_dict(convert.state_dict_from_jax(ref, model=model))
    x = rng.standard_normal((5, 4)).astype(np.float32)
    h = np.maximum(x @ ref["0.weight"] + ref["0.bias"], 0)
    want = h @ ref["2.weight"] + ref["2.bias"]
    got = model(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < 1e-5
    back = convert.state_dict_to_jax(model.state_dict(), model=model)
    assert all(np.array_equal(back[k], ref[k]) for k in ref)
    bad = dict(ref, **{"2.weight": np.zeros((3, 4), np.float32)})
    with pytest.raises(ValueError, match="2.weight"):
        convert.state_dict_from_jax(bad, model=model)
    # without a model, GPT's names still decide (the existing callers)
    assert set(convert.state_dict_from_jax(
        {"gpt.blocks.0.attn.qkv.weight": np.zeros((2, 6), np.float32)})[
        "gpt.blocks.0.attn.qkv.weight"].shape) == {6, 2}


@pytest.mark.parametrize("with_model", [True, False],
                         ids=["model", "names"])
def test_quantized_gpt_crosses_both_ways(with_model):
    """A reference GPT after `quantize_for_decode` (untied head, so every
    projection and the head are int8): ``quant_weight`` is ``[out, in]``
    on both sides and crosses untransposed, ``weight_scale`` and ``bias``
    as they are; the port gives the reference's logits (fp32, 1e-5 of
    the largest) and the state comes back bit for bit."""
    from paddle_tpu.nn.quant import quantize_for_decode as jquant
    from paddle_tpu_torch.nn.quant import quantize_for_decode as tquant

    cfg = dict(TINY, tie_word_embeddings=False)
    paddle.seed(3)
    jm = jquant(JModel(JConfig(**cfg)))
    jm.eval()
    ref = {n: np.asarray(t._data) for n, t in jm.state_dict().items()}
    name = "gpt.blocks.1.attn.qkv.quant_weight"
    assert ref[name].dtype == np.int8 and ref[name].shape == (96, 32)
    assert "lm_head.quant_weight" in ref
    tm = tquant(GPTForCausalLM(GPTConfig(**cfg), device="cpu"))
    tm.eval()
    sd = convert.state_dict_from_jax(ref, model=tm if with_model else None)
    assert sd[name].dtype == torch.int8 and tuple(sd[name].shape) == (96, 32)
    tm.load_state_dict(sd)
    ids = np.random.default_rng(2).integers(1, 96, (2, 9))
    want = np.asarray(jm(paddle.to_tensor(ids, dtype="int64"))._data)
    got = tm(torch.from_numpy(ids)).detach().numpy()
    assert _rel(got, want) < 1e-5
    back = convert.state_dict_to_jax(tm.state_dict(),
                                     model=tm if with_model else None)
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype and \
            np.array_equal(back[k], ref[k]), k


def test_resnet_fc_weight_is_transposed():
    paddle.seed(0)
    jm = jresnet18(num_classes=10)
    tm = resnet18(num_classes=10, device="cpu")
    sd = convert.state_dict_from_jax(
        {n: np.asarray(t._data) for n, t in jm.state_dict().items()},
        model=tm)
    assert tuple(sd["fc.weight"].shape) == (10, 512)
    assert np.array_equal(sd["fc.weight"].numpy(),
                          np.asarray(jm.fc.weight._data).T)


# ---------------------------------------------------------------------------
# the format itself
# ---------------------------------------------------------------------------

def test_formats_cross_bit_for_bit(tmp_path):
    rng = np.random.default_rng(10)
    bf = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    obj = {"w": paddle.to_tensor(rng.standard_normal((2, 3)).astype(
               np.float32)),
           "b": paddle.to_tensor(np.asarray(bf)),
           "i": paddle.to_tensor(np.arange(4), dtype="int64"),
           "scalar": paddle.to_tensor(np.float32(2.5)),
           "moment": bf, "n": np.arange(3, dtype=np.int32), "step": 7,
           "nested": [("x", 1.5), {"y": None}]}
    path = str(tmp_path / "ref.pd")
    paddle.save(obj, path)
    got = pt.load(path)
    assert got["b"].dtype == torch.bfloat16 and got["moment"].dtype == \
        torch.bfloat16
    assert np.array_equal(got["b"].view(torch.int16).numpy(),
                          bf.view(np.int16))
    assert got["scalar"].shape == () and got["i"].dtype == torch.int64
    assert isinstance(got["n"], np.ndarray) and got["step"] == 7
    assert got["nested"] == [("x", 1.5), {"y": None}]
    raw = pt.load(path, return_numpy=True)
    assert isinstance(raw["b"], Bfloat16Bits)
    assert np.array_equal(raw["b"], bf.view(np.uint16))

    # tensors go out as the reference's payloads, bf16 bits as its
    # ml_dtypes arrays
    out = str(tmp_path / "port.pd")
    pt.save(dict(got, moment=raw["moment"]), out)
    back = paddle.load(out)
    for k in ("w", "b", "i", "scalar"):
        assert np.array_equal(np.asarray(back[k]._data),
                              np.asarray(obj[k]._data)), k
    assert back["moment"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(back["moment"].view(np.uint16),
                          bf.view(np.uint16))


def test_load_maps_numpy_core_and_refuses_unknown_globals(tmp_path):
    path = tmp_path / "np1.pd"
    data = pickle.dumps({"a": np.arange(3, dtype=np.float32)}, protocol=2)
    data = data.replace(b"numpy._core.multiarray", b"numpy.core.multiarray")
    path.write_bytes(data)
    assert np.array_equal(pt.load(str(path))["a"], np.arange(3))
    evil = tmp_path / "evil.pd"
    evil.write_bytes(pickle.dumps({"a": os.getcwd}, protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        pt.load(str(evil))


def test_save_is_crash_safe(tmp_path):
    path = str(tmp_path / "ck.pd")
    pt.save({"a": torch.ones(2)}, path)
    with pytest.raises(Exception):
        pt.save({"a": torch.zeros(2), "bad": lambda: 0}, path)
    assert torch.equal(pt.load(path)["a"], torch.ones(2))
    assert os.listdir(tmp_path) == ["ck.pd"]


_CHILD = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "ml_dtypes", "paddle_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.framework.io import Bfloat16Bits
    from paddle_tpu_torch.optimizer import AdamW
    src, dst = sys.argv[1:]
    ck = pt.load(src)
    lin = torch.nn.Linear(4, 3).bfloat16()
    lin.load_state_dict(convert.state_dict_from_jax(ck["model"], model=lin))
    opt = AdamW(parameters=lin.parameters(), multi_precision=True,
                moment_dtype="bfloat16")
    opt.set_state_dict(convert.optimizer_state_from_jax(ck["opt"], lin, opt))
    assert opt._accumulators["moment1"][lin.weight].dtype == torch.bfloat16
    out = convert.state_dict_to_jax(lin.state_dict(), model=lin)
    assert isinstance(out["weight"], Bfloat16Bits)
    back = convert.optimizer_state_to_jax(opt.state_dict(), lin, opt)
    pt.save({"model": convert.state_dict_to_jax(lin.state_dict(), model=lin,
                                                tensors=True),
             "opt": back}, dst)
    assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m]]
    print("ok")
""")


def test_load_and_save_without_jax_or_ml_dtypes(tmp_path):
    """The card's machine has neither: a subprocess with both blocked
    (and the JAX package) reads a reference file and writes one, bf16
    crossing as its bits; the JAX package reads that file bit for bit."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)
    m1 = rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)
    src, dst = str(tmp_path / "ref.pd"), str(tmp_path / "port.pd")
    paddle.save({"model": {"weight": paddle.to_tensor(np.asarray(w)),
                           "bias": paddle.to_tensor(np.zeros(
                               3, ml_dtypes.bfloat16))},
                 "opt": {"accumulators": {"moment1": {
                     "param_7": m1, "param_8": np.zeros(3, np.float32)}},
                     "master_weights": {
                         "param_7": w.astype(np.float32),
                         "param_8": np.zeros(3, np.float32)},
                     "step": 3}}, src)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run([sys.executable, "-c", _CHILD, src, dst], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr
    back = paddle.load(dst)
    assert np.array_equal(np.asarray(back["model"]["weight"]._data)
                          .view(np.uint16), w.view(np.uint16))
    got = back["opt"]["accumulators"]["moment1"]["param_0"]
    assert got.dtype == ml_dtypes.bfloat16
    assert np.array_equal(got.view(np.uint16), m1.view(np.uint16))
    assert back["opt"]["step"] == 3
