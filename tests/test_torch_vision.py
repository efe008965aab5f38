"""The vision slice of the PyTorch port (conv, batch norm, pooling, the
ResNet family, ResNet training through `TrainStep`) against the JAX
package.

Inputs and weights are numpy arrays from a seed, handed to both
packages; weights cross through `convert.state_dict_from_jax(...,
model=)`. On CPU tensors the port runs aten's convolution, batch norm
and pooling. Bars:

* functionals and one `BottleneckBlock`: outputs within 1e-5 of the
  output's largest magnitude, input and weight gradients within 1e-4 of
  the gradient's largest magnitude, running statistics within 1e-6
  (fp32 sums in another order);
* resnet18 at 32 x 32, batch 4, 10 classes, `Momentum(0.1, 0.9)`, 3
  `TrainStep`s: loss |diff| < 5e-4, parameters, velocities and batch
  norm buffers relative < 5e-3 (the reference's own bars,
  tests/test_training_kernels.py), then ``eval()`` logits within 1e-4 of
  their largest magnitude. Each step starts from the reference's state
  (parameters, buffers and velocities carried into the port by
  `convert`): at this size a trajectory is chaotic (batch norm over 4
  values a channel in layer4 amplifies rounding; a 1e-7 relative change
  of the weights moves the port's own third loss past the loss bar,
  `test_a_free_running_resnet18_trajectory_is_chaotic`), so a
  free-running comparison would measure the chaos, not the port;
* a guarded step over a batch with an inf: the buffers bit-identical to
  before the step in both packages, and the next finite step within the
  bars above.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as popt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tvm

LOSS_BAR, REL_BAR = 5e-4, 5e-3


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jt(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _tt(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _jgrad(t):
    return np.asarray(t.grad._data)


# ---------------------------------------------------------------------------
# 1. the functionals, forward and backward
# ---------------------------------------------------------------------------

CONV_CASES = {
    "3x3 pad 1": dict(cin=4, cout=6, k=3, stride=1, padding=1, dilation=1,
                      groups=1),
    "7x7 stride 2 pad 3": dict(cin=3, cout=8, k=7, stride=2, padding=3,
                               dilation=1, groups=1),
    "1x1 stride 2": dict(cin=8, cout=4, k=1, stride=2, padding=0,
                         dilation=1, groups=1),
    "groups 4, list padding": dict(cin=8, cout=8, k=3, stride=1,
                                   padding=[1, 2], dilation=1, groups=4),
    "dilation 2": dict(cin=4, cout=4, k=3, stride=1, padding=2, dilation=2,
                       groups=2),
    "pairs padding": dict(cin=4, cout=4, k=3, stride=[2, 1],
                          padding=[1, 1, 2, 2], dilation=1, groups=1),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case):
    c = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, c["cin"], 11, 9)).astype(np.float32)
    w = rng.standard_normal((c["cout"], c["cin"] // c["groups"], c["k"],
                             c["k"])).astype(np.float32) * 0.2
    b = rng.standard_normal(c["cout"]).astype(np.float32)
    kw = dict(stride=c["stride"], padding=c["padding"],
              dilation=c["dilation"], groups=c["groups"])
    jx, jw, jb = _jt(x, True), _jt(w, True), _jt(b, True)
    jout = JF.conv2d(jx, jw, jb, **kw)
    g = rng.standard_normal(tuple(jout.shape)).astype(np.float32)
    (jout * _jt(g)).sum().backward()
    tx, tw, tb = _tt(x, True), _tt(w, True), _tt(b, True)
    tout = PF.conv2d(tx, tw, tb, **kw)
    (tout * _tt(g)).sum().backward()
    assert _rel(tout.detach(), jout._data) < 1e-5
    for t, j in ((tx, jx), (tw, jw), (tb, jb)):
        assert _rel(t.grad, _jgrad(j)) < 1e-4


def test_conv2d_refuses_what_is_not_ported():
    x, w = torch.zeros(1, 2, 5, 5), torch.zeros(2, 2, 3, 3)
    for kw in (dict(padding="SAME"), dict(padding=[0, 1, 1, 1]),
               dict(data_format="NHWC")):
        with pytest.raises(NotImplementedError, match="A10"):
            PF.conv2d(x, w, **kw)


@pytest.mark.parametrize("training,global_stats,layout", [
    (True, None, "NCHW"), (False, None, "NCHW"), (True, True, "NCHW"),
    (True, None, "NHWC"), (True, None, "NC")])
def test_batch_norm_matches_jax(training, global_stats, layout):
    """Forward, input/weight/bias gradients and the running statistics
    (Paddle's momentum, the unbiased running variance)."""
    rng = np.random.default_rng(1)
    shape = {"NCHW": (4, 3, 5, 6), "NHWC": (4, 5, 6, 3), "NC": (7, 3)}[layout]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(3).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    rm = rng.standard_normal(3).astype(np.float32)
    rv = (1 + rng.random(3)).astype(np.float32)
    kw = dict(training=training, momentum=0.9, epsilon=1e-5,
              data_format="NCHW" if layout == "NC" else layout,
              use_global_stats=global_stats)
    jx, jw, jb = _jt(x, True), _jt(w, True), _jt(b, True)
    jrm, jrv = _jt(rm), _jt(rv)
    jout = JF.batch_norm(jx, jrm, jrv, jw, jb, **kw)
    g = rng.standard_normal(shape).astype(np.float32)
    (jout * _jt(g)).sum().backward()
    tx, tw, tb = _tt(x, True), _tt(w, True), _tt(b, True)
    trm, trv = _tt(rm), _tt(rv)
    tout = PF.batch_norm(tx, trm, trv, tw, tb, **kw)
    (tout * _tt(g)).sum().backward()
    assert _rel(tout.detach(), jout._data) < 1e-5
    for t, j in ((tx, jx), (tw, jw), (tb, jb)):
        assert _rel(t.grad, _jgrad(j)) < 1e-4
    assert np.abs(trm.numpy() - np.asarray(jrm._data)).max() < 1e-6
    assert np.abs(trv.numpy() - np.asarray(jrv._data)).max() < 1e-6
    moved = training and not global_stats
    assert moved == (not np.array_equal(trm.numpy(), rm))


def test_batch_norm_bf16_keeps_fp32_statistics():
    """bf16 input: statistics in fp32, a bf16 output, fp32 buffers
    updated, as in the reference."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 4, 4)).astype(np.float32)
    rm, rv = torch.zeros(3), torch.ones(3)
    out = PF.batch_norm(torch.from_numpy(x).bfloat16(), rm, rv,
                        training=True)
    jrm, jrv = _jt(np.zeros(3, np.float32)), _jt(np.ones(3, np.float32))
    jout = JF.batch_norm(_jt(x).astype("bfloat16"), jrm, jrv, training=True)
    assert out.dtype == torch.bfloat16 and rm.dtype == torch.float32
    assert _rel(out.float(), np.asarray(jout._data.astype(jnp.float32))) \
        < 1e-2
    assert np.abs(rv.numpy() - np.asarray(jrv._data)).max() < 1e-6


POOL_CASES = {
    "max 3x3 s2 p1": ("max", dict(kernel_size=3, stride=2, padding=1)),
    "max 2x2": ("max", dict(kernel_size=2)),
    "avg 3x3 s2 p1 exclusive": ("avg", dict(kernel_size=3, stride=2,
                                            padding=1, exclusive=True)),
    "avg 3x3 s2 p1 inclusive": ("avg", dict(kernel_size=3, stride=2,
                                            padding=1, exclusive=False)),
    "avg 2x2": ("avg", dict(kernel_size=2)),
    "adaptive 1x1": ("adaptive", dict(output_size=(1, 1))),
    "adaptive 3x2 uneven": ("adaptive", dict(output_size=(3, 2))),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pools_match_jax(case):
    kind, kw = POOL_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 7, 5)).astype(np.float32)
    jf = {"max": JF.max_pool2d, "avg": JF.avg_pool2d,
          "adaptive": JF.adaptive_avg_pool2d}[kind]
    tf = {"max": PF.max_pool2d, "avg": PF.avg_pool2d,
          "adaptive": PF.adaptive_avg_pool2d}[kind]
    jx, tx = _jt(x, True), _tt(x, True)
    jout, tout = jf(jx, **kw), tf(tx, **kw)
    g = rng.standard_normal(tuple(jout.shape)).astype(np.float32)
    (jout * _jt(g)).sum().backward()
    (tout * _tt(g)).sum().backward()
    assert tuple(tout.shape) == tuple(jout.shape)
    assert _rel(tout.detach(), jout._data) < 1e-6
    assert _rel(tx.grad, _jgrad(jx)) < 1e-6


def test_max_pool_ties_after_relu_cannot_change_a_gradient():
    """ResNet pools right after a ReLU, so whole windows of exact zeros
    are common. The packages may route a window's gradient to different
    zeros, but a zero came out of the ReLU at an input <= 0, whose
    gradient is 0 in both: the gradient at the ReLU's input agrees."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    x[:, :, :4, :4] = -np.abs(x[:, :, :4, :4])       # windows of zeros
    x[0, 0, 4, 4] = 0.0                              # a ReLU input at 0
    jx, tx = _jt(x, True), _tt(x, True)
    jout = JF.max_pool2d(JF.relu(jx), 3, stride=2, padding=1)
    tout = PF.max_pool2d(torch.relu(tx), 3, stride=2, padding=1)
    g = rng.standard_normal(tuple(jout.shape)).astype(np.float32)
    (jout * _jt(g)).sum().backward()
    (tout * _tt(g)).sum().backward()
    assert np.array_equal(tout.detach().numpy(), np.asarray(jout._data))
    assert np.array_equal(tx.grad.numpy(), _jgrad(jx))
    assert not tx.grad[:, :, :4, :4].any()
    assert tx.grad[0, 0, 4, 4] == 0


def test_pooling_refuses_what_is_not_ported():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(NotImplementedError, match="A10"):
        PF.max_pool2d(x, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="A10"):
        PF.max_pool2d(x, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="A10"):
        PF.avg_pool2d(x, 2, divisor_override=3)


# ---------------------------------------------------------------------------
# 2. layers and models: names, shapes, initialisers, one block
# ---------------------------------------------------------------------------

def _load_jax_weights(jm, tm, seed=0):
    """Numpy weights and buffers from ``seed`` into the reference model,
    carried into the port's by `convert`; returns them."""
    rng = np.random.default_rng(seed)
    named = {}
    for name, t in jm.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("_variance"):
            a = 0.5 + rng.random(shape)
        elif name.endswith("_mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif name.endswith(("bn1.weight", "bn2.weight", "bn3.weight",
                            "downsample.1.weight")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = np.asarray(t._data) * (1.0 + 0.1 * rng.standard_normal(
                shape))
        a = a.astype(np.float32)
        t._data = jnp.asarray(a)
        named[name] = a
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    return named


def test_bottleneck_block_matches_jax():
    """One `BottleneckBlock` with a strided downsample, in training:
    output, every parameter gradient, the input gradient and the running
    statistics."""
    paddle.seed(0)
    jds = paddle.nn.Sequential(paddle.nn.Conv2D(16, 32, 1, stride=2,
                                                bias_attr=False),
                               paddle.nn.BatchNorm2D(32))
    jb = jresnet.BottleneckBlock(16, 8, stride=2, downsample=jds)
    tds = torch.nn.Sequential(pnn.Conv2D(16, 32, 1, stride=2,
                                         bias_attr=False),
                              pnn.BatchNorm2D(32))
    tb = tvm.BottleneckBlock(16, 8, stride=2, downsample=tds)
    assert sorted(tb.state_dict()) == sorted(jb.state_dict())
    _load_jax_weights(jb, tb)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16, 8, 8)).astype(np.float32)
    jx, tx = _jt(x, True), _tt(x, True)
    jout, tout = jb(jx), tb(tx)
    g = rng.standard_normal(tuple(jout.shape)).astype(np.float32)
    (jout * _jt(g)).sum().backward()
    (tout * _tt(g)).sum().backward()
    assert _rel(tout.detach(), jout._data) < 1e-5
    assert _rel(tx.grad, _jgrad(jx)) < 1e-4
    jgrads = convert.state_dict_from_jax(
        {n: _jgrad(p) for n, p in jb.named_parameters()})
    for name, p in tb.named_parameters():
        assert _rel(p.grad, jgrads[name]) < 1e-4, name
    for name, b in tb.named_buffers():
        want = np.asarray(dict(jb.named_buffers())[name]._data)
        assert np.abs(b.numpy() - want).max() < 1e-6, name


@pytest.mark.parametrize("ctor", ["resnet50", "resnet18",
                                  "resnext50_32x4d"])
def test_resnet_state_dict_names_and_shapes_equal_the_reference(ctor):
    paddle.seed(0)
    jm = getattr(jresnet, ctor)(num_classes=1000)
    tm = getattr(tvm, ctor)(num_classes=1000, device="cpu")
    want = {n: tuple(t.shape) for n, t in jm.state_dict().items()}
    got = convert.state_dict_to_jax(tm.state_dict(), model=tm)
    assert sorted(got) == sorted(want)
    assert {n: a.shape for n, a in got.items()} == want
    assert not any("num_batches_tracked" in n for n in tm.state_dict())
    assert isinstance(tm.fc, torch.nn.Linear)
    assert tuple(tm.fc.weight.shape) == (1000, want["fc.weight"][0])


CONSTRUCTORS = [n for n in tvm.__all__ if n.startswith(("resnet", "wide",
                                                      "resnext"))]


def test_every_constructor_passes_the_reference_arguments(monkeypatch):
    """The thirteen constructors share `ResNet`: each passes the
    reference's block, depth, width and groups."""
    def record(block, depth=50, width=64, **kw):
        return (block.__name__, depth, width, kw.get("groups", 1))

    monkeypatch.setattr(jresnet, "ResNet", record)
    monkeypatch.setattr(tvm.resnet, "ResNet", record)
    assert len(CONSTRUCTORS) == 13
    for name in CONSTRUCTORS:
        assert getattr(tvm, name)() == getattr(jresnet, name)(), name


def test_layer_initialisers_follow_the_reference():
    conv = pnn.Conv2D(8, 4, 3, generator=torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(8 * 9)
    assert conv.weight.abs().max() <= bound and conv.bias is not None
    assert conv.weight.abs().max() > 0.9 * bound
    lin = pnn.Linear(30, 20)
    limit = np.sqrt(6.0 / 50)
    assert lin.weight.abs().max() <= limit and not lin.bias.any()
    bn = pnn.BatchNorm2D(5)
    assert bn.weight.eq(1).all() and not bn.bias.any()
    assert list(bn.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    assert pnn.BatchNorm2D(5, weight_attr=False).weight is None
    # attrs and soft labels, ported since (ROADMAP A3)
    fixed = pnn.Conv2D(2, 2, 1, weight_attr=pnn.ParamAttr(
        initializer=pnn.initializer.Constant(0.5)), bias_attr=False)
    assert fixed.weight.eq(0.5).all() and fixed.bias is None
    soft = torch.softmax(torch.randn(3, 4), -1)
    assert torch.isfinite(pnn.CrossEntropyLoss(soft_label=True)(
        torch.randn(3, 4), soft))
    a = tvm.resnet18(num_classes=10, device="cpu", seed=3)
    b = tvm.resnet18(num_classes=10, device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def _counter_order(jm):
    return [n for n, p in sorted(jm.named_parameters(),
                                 key=lambda x: int(x[1].name[6:]))]


@pytest.mark.parametrize("model", ["gpt tied", "gpt untied", "resnet18"])
def test_reference_counter_order_is_the_port_creation_order(model):
    """The optimizer map's premise (`convert.optimizer_state_from_jax`):
    the reference numbers its parameters ``param_<counter>`` in creation
    order, and the port's ``named_parameters()`` order is that order. For
    GPT (tied and untied head) it is also the reference's
    ``named_parameters()`` order; for ResNet it is not (the reference's
    block makes its downsample first and registers it last), and the
    port's block registers its downsample first."""
    paddle.seed(0)
    if model.startswith("gpt"):
        cfg = dict(vocab_size=64, hidden_size=16, num_layers=2,
                   num_attention_heads=2, max_position_embeddings=16,
                   tie_word_embeddings=model == "gpt tied")
        jm, tm = JGPT(JGPTConfig(**cfg)), GPTForCausalLM(GPTConfig(**cfg),
                                                          device="cpu")
        assert _counter_order(jm) == [n for n, _ in jm.named_parameters()]
    else:
        jm = jresnet.resnet18(num_classes=10)
        tm = tvm.resnet18(num_classes=10, device="cpu")
        assert _counter_order(jm) != [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in tm.named_parameters()] == _counter_order(jm)


# ---------------------------------------------------------------------------
# 3. resnet18 training through TrainStep
# ---------------------------------------------------------------------------

def _images(rng, b=4, hw=32, classes=10):
    return (rng.standard_normal((b, 3, hw, hw)).astype(np.float32),
            rng.integers(0, classes, (b,)))


def _pair(guard=False):
    paddle.seed(0)
    jm = jresnet.resnet18(num_classes=10)
    tm = tvm.resnet18(num_classes=10, device="cpu")
    _load_jax_weights(jm, tm)
    jcrit, tcrit = paddle.nn.CrossEntropyLoss(), pnn.CrossEntropyLoss()
    jopt = popt.Momentum(learning_rate=0.1, momentum=0.9,
                         parameters=jm.parameters())
    topt = Momentum(learning_rate=0.1, momentum=0.9,
                    parameters=tm.parameters())
    kw = dict(guard_nonfinite=True) if guard else {}
    jstep = JTrainStep(jm, lambda m, x, y: jcrit(m(x), y), jopt, **kw)
    tstep = TrainStep(tm, lambda m, x, y: tcrit(m(x), y), topt, **kw)
    return jm, tm, jopt, topt, jstep, tstep


def _jax_state(jm, tm):
    return convert.state_dict_from_jax(
        {n: np.asarray(t._data) for n, t in jm.state_dict().items()},
        model=tm)


def _sync_from_jax(jm, tm, jopt, topt):
    """The reference's parameters, buffers and velocities into the port
    (`convert`'s model and optimizer maps)."""
    tm.load_state_dict(_jax_state(jm, tm))
    topt.set_state_dict(convert.optimizer_state_from_jax(
        jopt.state_dict(), tm, topt))


def _assert_states_agree(jm, tm, jopt, topt):
    want = _jax_state(jm, tm)
    for name, t in tm.state_dict().items():
        assert _rel(t, want[name]) < REL_BAR, name
    vel = convert.optimizer_state_from_jax(jopt.state_dict(), tm, topt)
    got = topt.state_dict()["accumulators"]["velocity"]
    for key, v in vel["accumulators"]["velocity"].items():
        assert _rel(got[key], v) < REL_BAR, key


def _step(jstep, tstep, x, y):
    jl = float(jstep(_jt(x), paddle.to_tensor(y, dtype="int64")))
    tl = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
    return jl, tl


def test_resnet18_trainstep_matches_jax():
    jm, tm, jopt, topt, jstep, tstep = _pair()
    rng = np.random.default_rng(6)
    for i in range(3):
        if i:
            _sync_from_jax(jm, tm, jopt, topt)
        jl, tl = _step(jstep, tstep, *_images(rng))
        assert np.isfinite(tl) and abs(jl - tl) < LOSS_BAR, (i, jl, tl)
        _assert_states_agree(jm, tm, jopt, topt)
    assert topt._step_count == 3
    # eval: the running statistics normalise
    jm.eval()
    tm.eval()
    x, _ = _images(rng)
    jout = jm(_jt(x))
    tout = tm(torch.from_numpy(x))
    assert _rel(tout.detach(), jout._data) < 1e-4


def test_a_free_running_resnet18_trajectory_is_chaotic():
    """Why each parity step starts from the reference's state: two runs
    of the port alone, from weights 1e-7 apart (relative), part by more
    than the bars within 3 steps at this size (batch norm over 4 values
    a channel in layer4 amplifies rounding)."""
    runs = []
    for eps in (0.0, 1e-7):
        tm = tvm.resnet18(num_classes=10, device="cpu", seed=0)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in tm.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=tm.parameters())
        crit = pnn.CrossEntropyLoss()
        step = TrainStep(tm, lambda m, x, y: crit(m(x), y), opt)
        rng = np.random.default_rng(6)
        losses = [float(step(*(torch.from_numpy(a)
                               for a in _images(rng))))
                  for _ in range(3)]
        runs.append((losses, tm.state_dict()))
    (la, sa), (lb, sb) = runs
    assert abs(la[0] - lb[0]) < 1e-4
    assert abs(la[2] - lb[2]) > LOSS_BAR
    assert max(_rel(sa[k], sb[k]) for k in sa) > REL_BAR


def test_guarded_resnet_step_restores_the_buffers():
    """A guarded step over a batch with an inf: the forward moves the
    running statistics to NaN, and the gate puts them back bit for bit,
    in both packages (the port's step selected only the optimizer's
    state back before); the next finite step agrees."""
    jm, tm, jopt, topt, jstep, tstep = _pair(guard=True)
    rng = np.random.default_rng(7)
    x, y = _images(rng)
    jl, tl = _step(jstep, tstep, x, y)
    assert abs(jl - tl) < LOSS_BAR
    _sync_from_jax(jm, tm, jopt, topt)
    before = {n: t.clone() for n, t in tm.state_dict().items()}
    jbefore = {n: np.asarray(b._data) for n, b in jm.named_buffers()}
    bad = x.copy()
    bad[0, 0, 3, 3] = np.inf
    jl, tl = _step(jstep, tstep, bad, y)
    assert not np.isfinite(jl) and not np.isfinite(tl)
    for n, t in tm.state_dict().items():
        assert torch.equal(t, before[n]), n
    for n, b in jm.named_buffers():
        assert np.array_equal(np.asarray(b._data), jbefore[n]), n
    assert topt._step_count == 1 and int(tstep.guard.skipped) == 1
    jl, tl = _step(jstep, tstep, *_images(rng))
    assert abs(jl - tl) < LOSS_BAR, (jl, tl)
    _assert_states_agree(jm, tm, jopt, topt)
