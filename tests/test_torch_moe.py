"""Mixture-of-experts on one rank: the PyTorch port against the JAX
package (paddle_tpu/incubate/distributed/models/moe, paddle_tpu/models/
gpt.py's MoE blocks, incubate.nn.functional's fused_moe / fused_ec_moe).

Inputs and weights are drawn with numpy from a seed and cross through
`convert` (the expert stacks keep the reference's [E, in, out] layout);
the reference runs on the CPU as tests/test_moe.py runs it. Bars:

* the gates: dispatch masks equal, combine weights and the aux loss
  within 1e-6; the index form (`route`) gives the same slots, drops and
  weights as the dense form;
* `MoELayer` (fp32): output rtol 1e-5, the grads of the input, the gate
  and every expert stack within 1e-5 of their largest; the index form
  against the dense-mask plain form;
* `fused_moe` / `fused_ec_moe`: output and grads within 1e-5;
* a tiny MoE GPT, eager and scan: logits 2e-4, loss 5e-4; 3 `TrainStep`s
  and 3 `FusedScanTrainStep`s (``layer_chunk`` 1 and 2) with an active
  MoE clip: loss |diff| < 5e-4 each step and parameters relative < 5e-3
  (the reference's bars for two training paths,
  tests/test_training_kernels.py); the aux loss's grad reaches the gate
  under recompute, both policies; greedy dense generation's tokens
  equal; `convert`'s round trips bit for bit.

The distributed entry points that would drop the aux loss raise naming
ROADMAP A9b.3b (one parametrised case each).
"""
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JMoEClip, ExpertFFN as JExpertFFN,
    MoELayer as JMoELayer, top1_gating as jtop1, top2_gating as jtop2)
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.jit import FusedScanTrainStep as JFused
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, ExpertFFN, MoELayer, NaiveGate,
    global_gather, global_scatter, top1_gating, top2_gating)
from paddle_tpu_torch.incubate.distributed.models.moe.gate import route
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.jit import FusedScanTrainStep, TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
            num_experts=4, moe_capacity_factor=1.0)
LOSS_BAR, REL_BAR = 5e-4, 5e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _np(t):
    return np.asarray(getattr(t, "_data", t))


# ---------------------------------------------------------------------------
# 1. the gates
# ---------------------------------------------------------------------------

def _logits(case):
    rng = np.random.default_rng(0)
    if case == "tie":
        # rows with two or three equal maxima: the first index wins
        a = rng.standard_normal((12, 4)).astype(np.float32)
        a[::2, 1] = a[::2, 3] = 2.0
        a[1::4, :3] = 1.5
        return a
    return rng.standard_normal((24, 4)).astype(np.float32)


def _dense_of_route(experts, slots, keep, weights, e, c):
    """The [T, E, C] combine weights the index form stands for."""
    t = experts.shape[0]
    out = np.zeros((t, e, c), np.float32)
    for i in range(t):
        for j in range(experts.shape[1]):
            if keep[i, j]:
                out[i, experts[i, j], slots[i, j]] += weights[i, j]
    return out


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case,capacity", [
    ("full", 24), ("drop", 3), ("second-queue", 8), ("tie", 4)])
def test_gates_match_reference(top_k, case, capacity):
    logits = _logits(case)
    jfn, tfn = (jtop1, top1_gating) if top_k == 1 else (jtop2, top2_gating)
    jc, jd, ja = jfn(jnp.asarray(logits), capacity)
    tc, td, ta = tfn(torch.from_numpy(logits), capacity)
    assert np.array_equal(td.numpy(), _np(jd)), case
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=0, atol=1e-6)
    assert abs(float(ta) - float(ja)) < 1e-6
    # the index form: the same slots, drops and weights
    ex, sl, kp, w, aux = route(torch.from_numpy(logits), capacity, top_k)
    e = logits.shape[1]
    np.testing.assert_allclose(
        _dense_of_route(ex.numpy(), sl.numpy(), kp.numpy(), w.numpy(), e,
                        capacity), _np(jc), rtol=0, atol=1e-6)
    assert float(aux) == float(ta)
    assert torch.equal(ex[:, 0], torch.from_numpy(logits).argmax(-1))
    if case == "tie":
        # first index of each row's maximum
        assert ex[0, 0].item() == 1 and ex[1, 0].item() == 0
    if top_k == 2:
        # second choices queue behind every first choice of their expert
        firsts = np.bincount(ex[:, 0].numpy(), minlength=e)
        assert (sl[:, 1].numpy() >= firsts[ex[:, 1].numpy()]).all()
        if case == "second-queue":
            dropped = ~kp.numpy()
            assert dropped[:, 1].any() and dropped.sum() < dropped.size
    if case == "drop":
        assert (~kp).any() and kp.any()


# ---------------------------------------------------------------------------
# 2. MoELayer
# ---------------------------------------------------------------------------

def _layer_weights(d=16, h=32, e=4, seed=1):
    rng = np.random.default_rng(seed)
    return {"gate_weight": rng.standard_normal((d, e)).astype(np.float32),
            "experts__fc1__weight":
                0.2 * rng.standard_normal((e, d, h)).astype(np.float32),
            "experts__fc1__bias":
                0.1 * rng.standard_normal((e, h)).astype(np.float32),
            "experts__fc2__weight":
                0.2 * rng.standard_normal((e, h, d)).astype(np.float32),
            "experts__fc2__bias":
                0.1 * rng.standard_normal((e, d)).astype(np.float32)}


def _layers(gate, cf, named):
    paddle.seed(0)
    jl = JMoELayer(16, [JExpertFFN(16, 32) for _ in range(4)], gate=gate,
                   capacity_factor=cf)
    for n, p in jl.named_parameters():
        p._data = jnp.asarray(named[n])
    tl = MoELayer(16, [ExpertFFN(16, 32) for _ in range(4)], gate=gate,
                  capacity_factor=cf)
    tl.load_state_dict(convert.state_dict_from_jax(named, model=tl))
    return jl, tl


@pytest.mark.parametrize("gate,cf", [("gshard", 1.0), ("switch", 0.75),
                                     ("gshard", float("inf")),
                                     ("naive", 2.0)])
def test_moe_layer_output_and_grads_match_reference(gate, cf):
    named = _layer_weights()
    jl, tl = _layers(gate, cf, named)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 12, 16)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jl(jx)
    ((jy * paddle.to_tensor(cot)).sum() + 0.5 * jl.l_aux).backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl(tx)
    ((ty * torch.from_numpy(cot)).sum() + 0.5 * tl.l_aux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-6)
    assert abs(float(tl.l_aux.detach()) - float(jl.l_aux)) < 1e-6
    assert _rel(tx.grad.numpy(), _np(jx.grad)) < 1e-5
    for n, p in tl.named_parameters():
        assert _rel(p.grad.numpy(), _np(jl._parameters[n].grad)) < 1e-5, n
    # the index form against the dense-mask plain form
    with torch.no_grad():
        yd, ad = tl.forward_aux(tx.detach(), dense=True)
    torch.testing.assert_close(ty.detach(), yd, rtol=1e-6, atol=1e-6)
    assert float(ad) == float(tl.l_aux.detach())
    if gate == "switch":
        # 4 experts of 5 slots for 24 tokens: a dropped token's output
        # is exactly 0
        rows = ty.detach().reshape(-1, 16)
        assert tl.capacity(24) == 5
        assert (rows.abs().sum(-1) == 0).sum() >= 24 - 4 * 5


def test_identical_experts_match_the_dense_expert():
    """Every expert the same and nothing dropped: top-2's normalized
    weights sum to 1, so the layer is one ExpertFFN (the reference's own
    check, tests/test_moe.py)."""
    torch.manual_seed(0)
    dense = ExpertFFN(16, 32)
    experts = [ExpertFFN(16, 32) for _ in range(4)]
    for e in experts:
        e.load_state_dict(dense.state_dict())
    layer = MoELayer(16, experts, capacity_factor=float("inf"))
    x = torch.randn(2, 8, 16)
    torch.testing.assert_close(layer(x), dense(x), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 3. fused_moe and fused_ec_moe
# ---------------------------------------------------------------------------

def _grads_both(jfn, tfn, arrays, cot):
    jt = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    jy = jfn(*jt)
    (jy * paddle.to_tensor(cot)).sum().backward()
    tt = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ty = tfn(*tt)
    (ty * torch.from_numpy(cot)).sum().backward()
    return (_np(jy), [_np(t.grad) for t in jt]), (
        ty.detach().numpy(), [t.grad.numpy() for t in tt])


@pytest.mark.parametrize("topk,norm", [(2, True), (2, False), (1, False)])
def test_fused_moe_matches_reference(topk, norm):
    rng = np.random.default_rng(0)
    b, s, d, ff, e = 2, 3, 8, 16, 4
    arrays = [rng.standard_normal((b, s, d)).astype(np.float32) * 0.5,
              rng.standard_normal((d, e)).astype(np.float32) * 0.5,
              rng.standard_normal((e, d, 2 * ff)).astype(np.float32) * 0.2,
              rng.standard_normal((e, 1, 2 * ff)).astype(np.float32) * 0.1,
              rng.standard_normal((e, ff, d)).astype(np.float32) * 0.2,
              rng.standard_normal((e, 1, d)).astype(np.float32) * 0.1]
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(moe_topk=topk, norm_topk_prob=norm)
    (jy, jg), (ty, tg) = _grads_both(
        lambda *a: JIF.fused_moe(*a, **kw), lambda *a: IF.fused_moe(*a, **kw),
        arrays, cot)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)
    for i, (t, j) in enumerate(zip(tg, jg)):
        assert _rel(t, j) < 1e-5, i
    with pytest.raises(NotImplementedError, match="quantized"):
        IF.fused_moe(*[torch.from_numpy(a) for a in arrays],
                     quant_method="weight_only_int8")


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe_matches_reference(act):
    rng = np.random.default_rng(3)
    b, s, d, ff, e = 2, 32, 8, 16, 4
    arrays = [rng.standard_normal((b, s, d)).astype(np.float32) * 0.3,
              rng.standard_normal((b, s, e)).astype(np.float32),
              rng.standard_normal((e, d, ff)).astype(np.float32) * 0.2,
              rng.standard_normal((e, 1, ff)).astype(np.float32) * 0.1,
              rng.standard_normal((e, ff, d)).astype(np.float32) * 0.2,
              rng.standard_normal((e, 1, d)).astype(np.float32) * 0.1]
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    (jy, jg), (ty, tg) = _grads_both(
        lambda *a: JIF.fused_ec_moe(*a, act_type=act),
        lambda *a: IF.fused_ec_moe(*a, act_type=act), arrays, cot)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-6)
    for i, (t, j) in enumerate(zip(tg, jg)):
        assert _rel(t, j) < 1e-5, i


# ---------------------------------------------------------------------------
# 4. a tiny MoE GPT
# ---------------------------------------------------------------------------

def _gpt_weights(scan, gate="gshard", seed=0, **over):
    paddle.seed(0)
    jm = JModel(JConfig(**TINY, scan_layers=scan, moe_gate=gate, **over))
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if name.endswith("bias"):
            a *= 0.05
        elif "ln" in name:
            a = 1.0 + 0.1 * a
        elif "gate_weight" in name:
            a *= 0.5
        else:
            a *= 0.1
        named[name] = a
        p._data = jnp.asarray(a)
    jm.train()
    return jm, named


def _gpt_pair(scan, gate="gshard", **over):
    jm, named = _gpt_weights(scan, gate)
    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=scan, moe_gate=gate,
                                  **over), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    tm.train()
    return jm, tm


def _batch(seed=1, b=2, s=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, TINY["vocab_size"], (b, s)),
            rng.integers(0, TINY["vocab_size"], (b, s)))


def _jax_params(jm, tm):
    return {k: v.float().numpy() for k, v in convert.state_dict_from_jax(
        {n: np.asarray(p._data.astype(jnp.float32))
         for n, p in jm.named_parameters()}, model=tm).items()}


@pytest.mark.parametrize("scan,gate", [(False, "gshard"), (True, "gshard"),
                                       (False, "switch")])
def test_gpt_logits_and_loss_match_reference(scan, gate):
    jm, tm = _gpt_pair(scan, gate)
    ids, labels = _batch()
    jl = float(jm.loss(paddle.to_tensor(ids, dtype="int64"),
                       paddle.to_tensor(labels, dtype="int64")))
    tl = float(tm.loss(torch.from_numpy(ids), torch.from_numpy(labels)))
    assert abs(jl - tl) < LOSS_BAR, (jl, tl)
    assert abs(float(jm.gpt.moe_aux()) - float(tm.gpt.moe_aux())) < 1e-6
    jlog = _np(jm(paddle.to_tensor(ids, dtype="int64")))
    tlog = tm(torch.from_numpy(ids)).detach().numpy()
    assert np.abs(tlog - jlog).max() < 2e-4


@pytest.fixture(scope="module")
def trained():
    """3 steps of each training path in both packages: eager
    `TrainStep` (recompute "dots") and `FusedScanTrainStep` at
    ``layer_chunk`` 1 and 2, each with an active MoE clip (the
    reference's fused step takes the plain global-norm clip, which it is
    at one rank). An aux weight of 1 makes the aux loss most of the
    routers' grads, so a lost aux cotangent misses the bars."""
    ids, labels = _batch()
    out = {}
    for path in ("train", "fused1", "fused2"):
        scan = path != "train"
        aux = dict(moe_aux_weight=1.0)
        over = aux if scan else dict(use_recompute=True,
                                     recompute_policy="dots", **aux)
        # the reference's eager MoE block under recompute leaks its aux
        # (read back as a side attribute inside jax.checkpoint), so it
        # runs without; the port recomputes
        jm, named = _gpt_weights(scan, **aux)
        tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=scan, **over),
                            device="cpu")
        tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
        tm.train()
        jclip = JClip(0.05) if scan else JMoEClip(0.05)
        jopt = popt.AdamW(learning_rate=1e-2, parameters=jm.parameters(),
                          grad_clip=jclip)
        topt = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                     grad_clip=ClipGradForMOEByGlobalNorm(0.05))
        if scan:
            k = int(path[-1])
            jstep = JFused(jm, jopt, fused_head=True, layer_chunk=k)
            tstep = FusedScanTrainStep(tm, topt, fused_head=True,
                                       layer_chunk=k)
        else:
            fn = lambda m, x, y: m.loss(x, y)  # noqa: E731
            jstep, tstep = JTrainStep(jm, fn, jopt), TrainStep(tm, fn, topt)
        jl = [float(jstep(paddle.to_tensor(ids, dtype="int64"),
                          paddle.to_tensor(labels, dtype="int64")))
              for _ in range(3)]
        tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
              for _ in range(3)]
        out[path] = (jm, tm, jopt, topt, jl, tl)
    return out


@pytest.mark.parametrize("path", ["train", "fused1", "fused2"])
def test_training_matches_reference(trained, path):
    jm, tm, _, _, jl, tl = trained[path]
    assert max(abs(a - b) for a, b in zip(jl, tl)) < LOSS_BAR, (jl, tl)
    want = _jax_params(jm, tm)
    for n, p in tm.named_parameters():
        assert _rel(p.detach().numpy(), want[n]) < REL_BAR, n


def test_fused_scan_loss_holds_the_weighted_aux():
    """The fused step's loss is the eager ``loss`` of the same weights
    (CE plus the weighted layer mean of the aux), as the reference's
    test_aux_loss_in_fused_step_matches_eager holds it."""
    _, tm = _gpt_pair(True)
    ids, labels = (torch.from_numpy(a) for a in _batch())
    eager = float(tm.loss(ids, labels))
    step = FusedScanTrainStep(tm, AdamW(learning_rate=0.0,
                                        parameters=tm.parameters()))
    assert abs(float(step(ids, labels)) - eager) < 1e-5


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("policy", ["dots", "full"])
def test_aux_grad_reaches_the_gate_under_recompute(scan, policy):
    """The aux loss alone, differentiated under recompute, gives the
    routers the grads it gives them without recompute."""
    ids = torch.from_numpy(_batch()[0])
    grads = []
    for rc in (False, True):
        _, tm = _gpt_pair(scan, use_recompute=rc, recompute_policy=policy)
        tm.gpt(ids)
        gates = [p for n, p in tm.named_parameters() if "gate_weight" in n]
        grads.append(torch.autograd.grad(tm.gpt.moe_aux(), gates))
    for a, b in zip(*grads):
        assert a.abs().max() > 0
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


def test_greedy_generation_matches_reference():
    jm, tm = _gpt_pair(False)
    jm.eval()
    tm.eval()
    ids = _batch(seed=5, b=2, s=6)[0]
    want = _np(jm.generate(ids, 6, use_cache="dense"))
    got = tm.generate(ids, 6, use_cache="dense").numpy()
    assert np.array_equal(got, want), (got, want)


# ---------------------------------------------------------------------------
# 5. convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True])
def test_convert_round_trips_bit_for_bit(scan):
    _, named = _gpt_weights(scan)
    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=scan), device="cpu")
    sd = convert.state_dict_from_jax(named, model=tm)
    key = ("gpt.blocks.blocks__mlp__moe__experts__fc1__weight" if scan
           else "gpt.blocks.0.mlp.moe.experts__fc1__weight")
    # the stacks keep the reference's [.., E, in, out]
    assert np.array_equal(sd[key].numpy(), named[key])
    back = convert.state_dict_to_jax(sd, model=tm)
    assert set(back) == set(named)
    for n, a in named.items():
        assert np.array_equal(back[n], a), n
    # without a model the names decide the same
    assert np.array_equal(convert.state_dict_from_jax(named)[key].numpy(),
                          named[key])


@pytest.mark.parametrize("path", ["train", "fused1"])
def test_optimizer_state_round_trips_bit_for_bit(trained, path):
    jm, tm, jopt, topt, _, _ = trained[path]
    state = jopt.state_dict()
    state = {"accumulators": {acc: {k: _np(v) for k, v in st.items()}
                              for acc, st in state["accumulators"].items()},
             "master_weights": {k: _np(v) for k, v in
                                state.get("master_weights", {}).items()},
             "step": state.get("step", 0)}
    fresh = AdamW(learning_rate=1e-2, parameters=tm.parameters())
    fresh.set_state_dict(convert.optimizer_state_from_jax(state, tm, fresh))
    back = convert.optimizer_state_to_jax(
        fresh.state_dict(), tm, fresh,
        names={n: p.name for n, p in jm.named_parameters()})
    for acc, st in state["accumulators"].items():
        assert set(back["accumulators"][acc]) == set(st), acc
        for k, a in st.items():
            assert np.array_equal(np.asarray(back["accumulators"][acc][k]),
                                  a), (acc, k)


# ---------------------------------------------------------------------------
# 6. what raises, naming ROADMAP A9b.3b
# ---------------------------------------------------------------------------

def _hcg(**degrees):
    """A stand-in topology with the given axis degrees (1 elsewhere)."""
    axes = ("data", "model", "pipe", "sharding", "sep")
    return types.SimpleNamespace(**{
        f"get_{a}_parallel_world_size": (lambda d=degrees.get(a, 1): d)
        for a in axes})


def _refusals():
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        SegmentParallel, ShardingParallel, TensorParallel)
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.distributed.sharding import group_sharded as gs
    from paddle_tpu_torch.jit.sharded_scan import (
        ShardedFusedScanTrainStep, select_train_step)
    from paddle_tpu_torch.models import GPTForCausalLMPipe

    two = types.SimpleNamespace(nranks=2)
    return {
        "ShardedFusedScanTrainStep": lambda m, o: ShardedFusedScanTrainStep(
            m, o),
        "select_train_step": lambda m, o: select_train_step(
            m, o, mesh=tenv.RankMesh({"dp": 2})),
        "ep_axis": lambda m, o: select_train_step(m, o, ep_axis="ep"),
        "TensorParallel": lambda m, o: TensorParallel(m, _hcg(model=2)),
        "SegmentParallel": lambda m, o: SegmentParallel(m, _hcg(sep=2)),
        "ShardingParallel": lambda m, o: ShardingParallel(
            m, _hcg(sharding=2)),
        "GroupShardedStage3": lambda m, o: gs.GroupShardedStage3(m, o),
        "group_sharded_parallel": lambda m, o: gs.group_sharded_parallel(
            m, o, "os_g"),
        "DataParallel": lambda m, o: DataParallel(m, group=two),
        "MoELayer ep_degree": lambda m, o: MoELayer(
            16, [ExpertFFN(16, 32) for _ in range(4)], ep_degree=2),
        "MoELayer group": lambda m, o: MoELayer(
            16, [ExpertFFN(16, 32) for _ in range(4)], group=two),
        "ClipGradForMOEByGlobalNorm": lambda m, o:
            ClipGradForMOEByGlobalNorm(1.0, moe_group=two),
        "GPTForCausalLMPipe": lambda m, o: GPTForCausalLMPipe(
            GPTConfig(**TINY), 1, 1),
        "global_scatter": lambda m, o: global_scatter(None, None, None),
        "global_gather": lambda m, o: global_gather(None, None, None),
    }


@pytest.mark.parametrize("entry", list(_refusals()))
def test_distributed_entry_points_refuse_moe(entry):
    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=True), device="cpu")
    opt = AdamW(parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match=r"A9b\.3b"):
        _refusals()[entry](tm, opt)


def test_pipeline_refuses_moe_as_the_reference_does():
    from paddle_tpu_torch.jit.pipeline_step import PipelineScanTrainStep

    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=True), device="cpu")
    with pytest.raises(ValueError, match="MoE.*as in the reference"):
        PipelineScanTrainStep(tm, AdamW(parameters=tm.parameters()),
                              mesh=tenv.RankMesh({"dp": 1, "pp": 2}))


def test_world_of_one_entry_points_take_moe():
    """At one rank the steps the port routes to train an MoE model:
    `select_train_step` gives `FusedScanTrainStep` (scan) or `TrainStep`,
    and the gate takes its names."""
    from paddle_tpu_torch.jit.sharded_scan import select_train_step

    for scan, kind in ((True, FusedScanTrainStep), (False, TrainStep)):
        tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=scan),
                            device="cpu")
        opt = AdamW(parameters=tm.parameters())
        step = select_train_step(tm, opt, mesh=tenv.RankMesh({"dp": 1}))
        assert type(step) is kind
    assert NaiveGate("switch").top_k == 1 and NaiveGate("naive").top_k == 2
    with pytest.raises(ValueError, match="unknown gate"):
        NaiveGate("topk")
