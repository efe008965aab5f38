"""The optimizer layer of the PyTorch port against the JAX package.

Parameters and grads are drawn with numpy from a seed and handed to both
packages; on CPU tensors the port runs its kernels' plain versions
(`ops.kernels.multi_tensor`). Bars:

* the fused Adam/AdamW step (the default, ``use_multi_tensor``) against
  the reference's fused step: fp32 values within 1e-6 relative after one
  step (the same fp32 operations in the same order), and the repo's bar
  after 5 steps, parameters 5e-3 relative; bf16 parameters compare their
  fp32 masters, and bf16 moments add one bf16 ulp of the moment a step;
* ``use_multi_tensor`` True and False bit-identical on the CPU (one
  per-tensor rule, `adam_math`);
* the other optimizers, 3 steps, 1e-5 relative (the same rules; Python
  scalars meet fp32 tensors in other orders in the two frameworks);
* the schedulers' lr sequences exactly (both are plain Python floats);
* the clips 1e-6 relative, the eager GradScaler loop 1e-6 relative and
  its scale exactly; a guarded `TrainStep` makes no host read (the read
  paths raise inside the call) and skips bit-identically.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.ops.kernels import multi_tensor as mt

SHAPES = [(8, 4), (4,), (3, 5), (17,), (2, 3, 4)]
NAMES = [f"w{i}" for i in range(len(SHAPES))]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _grads(step, scale=3.0, seed=100):
    rng = np.random.default_rng(seed + step)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _jparams(arrays, dtype=torch.float32):
    out = []
    for name, a in zip(NAMES, arrays):
        p = paddle.to_tensor(a, stop_gradient=False)
        p._data = p._data.astype(JDT[dtype])
        p.name = name
        out.append(p)
    return out


def _tparams(arrays, dtype=torch.float32):
    return [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dtype))
            for a in arrays]


def _set_grads(jps, tps, gs):
    for jp, tp, g in zip(jps, tps, gs):
        jp.grad = paddle.to_tensor(g).astype(jp._data.dtype)
        tp.grad = torch.from_numpy(g).to(tp.dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# 1. the fused Adam / AdamW step against the reference's
# ---------------------------------------------------------------------------

def _named(ps):
    return list(zip(NAMES, ps))


# case -> the optimizer's keywords beside the test's own: the parameters'
# dtype, the class, a scheduler, need_clip on two parameters,
# apply_decay_param_fun, groups (all with a global-norm clip 1.0)
CASES = {
    "adamw_fp32": dict(),
    "adamw_bf16_master": dict(dtype=torch.bfloat16, multi_precision=True),
    "adamw_bf16_moments": dict(dtype=torch.bfloat16, multi_precision=True,
                               moment_dtype="bfloat16"),
    "adamw_fp32_bf16_moments": dict(moment_dtype="bfloat16"),
    "adamw_amsgrad": dict(amsgrad=True),
    "adam_l2": dict(cls="Adam", weight_decay=0.02),
    "adam_l2_amsgrad_bf16": dict(cls="Adam", weight_decay=0.02,
                                 amsgrad=True, dtype=torch.bfloat16,
                                 multi_precision=True),
    "decay_fun": dict(decay_fun=True),
    "groups": dict(groups=True),
    "need_clip": dict(need_clip=True),
    "scheduler": dict(scheduler=True),
}


def _build(framework, case, arrays, use_multi_tensor=None):
    """(params, optimizer, scheduler or None) of one framework."""
    c = dict(CASES[case])
    dtype = c.pop("dtype", torch.float32)
    cls_name = c.pop("cls", "AdamW")
    jax_side = framework == "jax"
    ps = _jparams(arrays, dtype) if jax_side else _tparams(arrays, dtype)
    mod = popt if jax_side else topt
    kw = dict(learning_rate=0.01, grad_clip=(JClip if jax_side
                                             else ClipGradByGlobalNorm)(1.0))
    if cls_name == "AdamW":
        kw["weight_decay"] = 0.05
    sched = None
    if c.pop("scheduler", False):
        sched = mod.lr.CosineAnnealingWithWarmupDecay(
            max_lr=0.02, min_lr=0.001, warmup_step=2, decay_step=6)
        kw["learning_rate"] = sched
    if c.pop("need_clip", False):
        ps[1].need_clip = False
        ps[3].need_clip = False
    params = ps
    if c.pop("decay_fun", False):
        kw["apply_decay_param_fun"] = lambda n: n not in ("w1", "w3")
        params = ps if jax_side else _named(ps)
    if c.pop("groups", False):
        params = [{"params": ps[:2], "learning_rate": 0.5,
                   "weight_decay": 0.2},
                  {"params": ps[2:3], "weight_decay": 0.0}] + ps[3:]
    if use_multi_tensor is not None:
        kw["use_multi_tensor"] = use_multi_tensor
    opt = getattr(mod, cls_name)(parameters=params, **kw, **c)
    return ps, opt, sched


def _values(framework, ps, opt):
    """Each parameter's fp32 value: the master where there is one."""
    out = []
    for p in ps:
        if framework == "jax":
            m = opt._master_weights.get(p.name)
            out.append(_f32(p._data if m is None else m))
        else:
            m = opt._master_weights.get(p)
            out.append((p.detach() if m is None else m).float().numpy())
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fused_adam_matches_jax(case):
    arrays = _init()
    jps, jopt, jsched = _build("jax", case, arrays)
    tps, topt_, tsched = _build("torch", case, arrays)
    bf16_moments = "bf16_moments" in case
    for step in range(5):
        _set_grads(jps, tps, _grads(step))
        jopt.step()
        topt_.step()
        jopt.clear_grad()
        topt_.clear_grad()
        for s in (jsched, tsched):
            if s is not None:
                s.step()
        jv, tv = _values("jax", jps, jopt), _values("torch", tps, topt_)
        for i, (a, b) in enumerate(zip(tv, jv)):
            if step == 0 and not bf16_moments:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{case} w{i}")
            else:
                assert _rel(a, b) < 5e-3, (case, step, i)
    assert topt_._step_count == int(jopt._step_count) == 5
    for name in ("moment1", "moment2"):
        for tp, jp in zip(tps, jps):
            t = topt_._accumulators[name][tp]
            j = jopt._accumulators[name][jp.name]
            assert str(t.dtype)[6:] == str(j.dtype)
            assert _rel(t.float().numpy(), _f32(j)) < 2e-2


@pytest.mark.parametrize("case", list(CASES))
def test_multi_tensor_on_and_off_bit_identical(case):
    """The fused plain version and the per-parameter loop, 4 steps, with
    the clip: every parameter, master and moment bit for bit."""
    arrays = _init(1)
    runs = []
    for fused in (True, False):
        tps, opt, sched = _build("torch", case, arrays, fused)
        for step in range(4):
            for p, g in zip(tps, _grads(step, seed=200)):
                p.grad = torch.from_numpy(g).to(p.dtype)
            opt.step()
            opt.clear_grad()
            if sched is not None:
                sched.step()
        runs.append((tps, opt))
    (pa, oa), (pb, ob) = runs
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    for p, q in zip(pa, pb):
        if p in oa._master_weights:
            assert torch.equal(oa._master_weights[p], ob._master_weights[q])
        for name, store in oa._accumulators.items():
            assert torch.equal(store[p], ob._accumulators[name][q])


def test_fused_adam_l2_one_step_rel_1e6_and_lr_ratio_accepted():
    """Adam's L2 term and AdamW's ``lr_ratio`` (accepted and not read, as
    in the reference) after one step."""
    arrays = _init(2)
    jps = _jparams(arrays)
    tps = _tparams(arrays)
    jopt = popt.AdamW(learning_rate=0.01, parameters=jps, lr_ratio=0.5)
    topt_ = topt.AdamW(learning_rate=0.01, parameters=tps, lr_ratio=0.5)
    _set_grads(jps, tps, _grads(0))
    jopt.step()
    topt_.step()
    for a, b in zip(_values("torch", tps, topt_), _values("jax", jps, jopt)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_state_dict_round_trip_continues_bit_identically():
    arrays = _init(3)
    tps, opt, sched = _build("torch", "scheduler", arrays)
    tps2, opt2, sched2 = _build("torch", "scheduler", arrays)
    for step in range(2):
        for p, g in zip(tps, _grads(step)):
            p.grad = torch.from_numpy(g)
        opt.step()
        opt.clear_grad()
        sched.step()
    sd = opt.state_dict()
    assert set(sd) == {"accumulators", "master_weights", "step",
                       "LR_Scheduler"}
    assert sd["step"] == 2 and set(sd["accumulators"]["moment1"]) == {
        f"param_{i}" for i in range(len(SHAPES))}
    with torch.no_grad():
        for a, b in zip(tps2, tps):
            a.copy_(b)
    opt2.set_state_dict(sd)
    assert opt2._step_count == 2 and sched2.last_epoch == sched.last_epoch
    for ps, o in ((tps, opt), (tps2, opt2)):
        for p, g in zip(ps, _grads(5)):
            p.grad = torch.from_numpy(g)
        o.step()
    for a, b in zip(tps, tps2):
        assert torch.equal(a, b)


def test_launch_plan_groups_and_splits():
    """The wrappers' launch plan: one dtype group a run of launches, at
    most MAX_TENSORS tensors each, empty tensors left out, first chunks
    counted in 2048-element chunks."""
    numels = [1, 0, 2048, 2049] + [7] * (mt.MAX_TENSORS + 3)
    keys = ["a", "a", "b", "a"] + ["a"] * (mt.MAX_TENSORS + 3)
    plan = mt._launches(numels, keys)
    assert [(g, len(ix)) for g, ix, _, _ in plan] == [
        ("a", mt.MAX_TENSORS), ("a", 5), ("b", 1)]
    g, idx, firsts, chunks = plan[0]
    assert idx[:3] == [0, 3, 4] and firsts[:3] == [0, 1, 3]
    assert chunks == 3 + (mt.MAX_TENSORS - 2)
    assert plan[2][1:] == ([2], [0], 1)


# ---------------------------------------------------------------------------
# 2. the kernels' plain versions
# ---------------------------------------------------------------------------

def test_norm_unscale_rounding_found_and_clip_scale():
    rng = np.random.default_rng(9)
    gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 50)
          for s in SHAPES]
    gs[2] = gs[2].bfloat16()
    inv = torch.tensor(1 / 64.0)
    clip = [True, False, True, True, True]
    want = [(g.float() * inv).to(g.dtype) for g in gs]
    stats, found = mt.multi_tensor_norm([g.clone() for g in gs], clip,
                                        inv_scale=inv, clip_norm=1.0)
    sq = sum(float(w.double().square().sum()) for w, c in zip(want, clip)
             if c)
    assert abs(float(stats[0]) - sq) <= 1e-6 * sq
    assert float(stats[1]) == pytest.approx(1.0 / np.sqrt(sq), rel=1e-6)
    assert not bool(found)
    written = [g.clone() for g in gs]
    mt.multi_tensor_norm(written, inv_scale=inv, write=True)
    for w, g in zip(written, want):
        assert torch.equal(w, g)
    gs[3][5] = float("inf")
    _, found = mt.multi_tensor_norm(gs)
    assert bool(found)


def test_adam_plain_gate_leaves_every_byte():
    arrays = _init(4)
    ps = _tparams(arrays, torch.bfloat16)
    masters = [p.detach().float() for p in ps]
    ms = [torch.randn(p.shape).bfloat16() for p in ps]
    vs = [torch.rand(p.shape).bfloat16() for p in ps]
    before = [t.clone() for t in ps + masters + ms + vs]
    step = torch.tensor(3, dtype=torch.int32)
    grads = [torch.from_numpy(g).bfloat16() for g in _grads(0)]
    mt.multi_tensor_adam(ps, grads, masters, ms, vs, lr=0.1, beta1=0.9,
                         beta2=0.999, eps=1e-8, step=step,
                         found_inf=torch.tensor(True))
    assert int(step) == 3
    for a, b in zip(ps + masters + ms + vs, before):
        assert torch.equal(a, b)
    mt.multi_tensor_adam(ps, grads, masters, ms, vs, lr=0.1, beta1=0.9,
                         beta2=0.999, eps=1e-8, step=step,
                         found_inf=torch.tensor(False))
    assert int(step) == 4 and not torch.equal(masters[0], before[5])


# ---------------------------------------------------------------------------
# 3. the other optimizers
# ---------------------------------------------------------------------------

OTHERS = {
    "SGD": dict(weight_decay=0.01),
    "Momentum": dict(momentum=0.9, weight_decay=0.01),
    "Momentum_nesterov": dict(cls="Momentum", momentum=0.9,
                              use_nesterov=True),
    "Adamax": dict(),
    "Adadelta": dict(learning_rate=1.0),
    "Adagrad": dict(initial_accumulator_value=0.1),
    "RMSProp": dict(momentum=0.5),
    "RMSProp_centered": dict(cls="RMSProp", centered=True),
    "ASGD": dict(batch_num=2),
    "Lamb": dict(),
    "NAdam": dict(),
    "RAdam": dict(),
    "Rprop": dict(),
    "LBFGS": dict(),
}


@pytest.mark.parametrize("name", list(OTHERS))
def test_other_optimizers_match_jax(name):
    kw = dict(OTHERS[name])
    cls = kw.pop("cls", name)
    kw.setdefault("learning_rate", 0.01)
    arrays = _init(5)
    jps, tps = _jparams(arrays), _tparams(arrays)
    jopt = getattr(popt, cls)(parameters=jps, **kw)
    topt_ = getattr(topt, cls)(parameters=tps, **kw)
    for step in range(3):
        _set_grads(jps, tps, _grads(step, scale=1.0, seed=300))
        jopt.step()
        topt_.step()
        jopt.clear_grad()
        topt_.clear_grad()
    for i, (tp, jp) in enumerate(zip(tps, jps)):
        np.testing.assert_allclose(tp.detach().numpy(), _f32(jp._data),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} w{i}")
    assert topt_._step_count == 3


def test_l2_decay_and_group_lr_on_a_per_parameter_optimizer():
    arrays = _init(6)
    jps, tps = _jparams(arrays), _tparams(arrays)
    groups = lambda ps: [{"params": ps[:2], "learning_rate": 0.1,  # noqa
                          "weight_decay": 0.5}] + ps[2:]
    jopt = popt.Momentum(learning_rate=0.05, parameters=groups(jps),
                         weight_decay=0.01)
    topt_ = topt.Momentum(learning_rate=0.05, parameters=groups(tps),
                          weight_decay=0.01)
    for step in range(3):
        _set_grads(jps, tps, _grads(step, scale=1.0))
        jopt.step()
        topt_.step()
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.detach().numpy(), _f32(jp._data),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# 4. the schedulers
# ---------------------------------------------------------------------------

def _schedulers(mod):
    lr = mod.lr
    return {
        "NoamDecay": lambda: lr.NoamDecay(64, 5, learning_rate=2.0),
        "PiecewiseDecay": lambda: lr.PiecewiseDecay([3, 8], [0.1, 0.05,
                                                             0.01]),
        "NaturalExpDecay": lambda: lr.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: lr.InverseTimeDecay(0.5, 0.1),
        "PolynomialDecay": lambda: lr.PolynomialDecay(0.5, 10, cycle=True),
        "LinearWarmup": lambda: lr.LinearWarmup(
            lr.StepDecay(0.5, 4), 5, 0.0, 0.5),
        "ExponentialDecay": lambda: lr.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lambda: lr.MultiStepDecay(0.5, [4, 9, 20]),
        "StepDecay": lambda: lr.StepDecay(0.5, 7, gamma=0.5),
        "LambdaDecay": lambda: lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lambda: lr.MultiplicativeDecay(
            0.5, lambda e: 0.9),
        "CosineAnnealingDecay": lambda: lr.CosineAnnealingDecay(0.5, 12),
        "CosineAnnealingWarmRestarts": lambda: (
            lr.CosineAnnealingWarmRestarts(0.5, 4, T_mult=2)),
        "ReduceOnPlateau": lambda: lr.ReduceOnPlateau(
            0.5, patience=2, cooldown=1),
        "OneCycleLR": lambda: lr.OneCycleLR(0.5, 25),
        "CyclicLR": lambda: lr.CyclicLR(0.01, 0.5, 4, mode="triangular2"),
        "LinearLR": lambda: lr.LinearLR(0.5, 12),
        "CosineAnnealingWithWarmupDecay": lambda: (
            lr.CosineAnnealingWithWarmupDecay(0.5, 0.01, 5, 20)),
    }


def _walk(s, steps, start=0):
    out = []
    for i in range(start, start + steps):
        out.append(s.get_lr())
        if isinstance(s, (popt.lr.ReduceOnPlateau, topt.lr.ReduceOnPlateau)):
            s.step(metrics=[1.0, 0.9, 0.95, 0.97, 0.99][i % 5])
        else:
            s.step()
    return out


@pytest.mark.parametrize("name", list(_schedulers(popt)))
def test_scheduler_matches_jax_and_round_trips(name):
    j = _schedulers(popt)[name]()
    t = _schedulers(topt)[name]()
    assert type(t).__module__ == "paddle_tpu_torch.optimizer.lr"
    assert _walk(t, 30) == _walk(j, 30)
    again = _schedulers(topt)[name]()
    again.set_state_dict(t.state_dict())
    assert _walk(again, 5, 30) == _walk(t, 5, 30)


def test_the_port_has_every_reference_scheduler():
    import inspect

    want = {n for n, c in inspect.getmembers(popt.lr, inspect.isclass)
            if issubclass(c, popt.lr.LRScheduler)}
    got = {n for n, c in inspect.getmembers(topt.lr, inspect.isclass)
           if issubclass(c, topt.lr.LRScheduler)}
    assert want == got and len(got) == 19
    assert want - {"LRScheduler"} == set(_schedulers(popt))


def test_scheduler_lr_minimize_and_clear_gradients():
    opt = topt.SGD(learning_rate=topt.lr.StepDecay(0.1, 2),
                   parameters=_tparams(_init()))
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    opt.set_lr_scheduler(topt.lr.StepDecay(0.3, 2))
    assert opt.get_lr() == 0.3
    ps = opt._parameter_list
    for p in ps:
        p.grad = torch.ones_like(p)
    before = ps[0].detach().clone()
    assert opt.minimize(None) == (None, None)       # the step, as step()
    assert torch.equal(ps[0].detach(), before - 0.3)
    opt.clear_gradients()
    assert all(p.grad is None for p in ps)


# ---------------------------------------------------------------------------
# 5. the clips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["value", "norm"])
def test_clip_by_value_and_norm_match_jax(kind):
    gs = _grads(0, scale=4.0)
    jps, tps = _jparams(_init()), _tparams(_init())
    jps[1].need_clip = tps[1].need_clip = False
    jc = jnn.ClipGradByValue(1.5, -0.5) if kind == "value" \
        else jnn.ClipGradByNorm(2.0)
    tc = ClipGradByValue(1.5, -0.5) if kind == "value" \
        else ClipGradByNorm(2.0)
    jout = jc(list(zip(jps, [paddle.to_tensor(g) for g in gs])))
    tout = tc(list(zip(tps, [torch.from_numpy(g.copy()) for g in gs])))
    for (_, t), (_, j), g in zip(tout, jout, gs):
        np.testing.assert_allclose(t.numpy(), _f32(j._data), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(tout[1][1].numpy(), gs[1])


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    gs = _grads(1, scale=2.0)
    jps, tps = _jparams(_init()), _tparams(_init())
    _set_grads(jps, tps, gs)
    jt = jnn.clip.clip_grad_norm_(jps, 3.0, norm_type=norm_type)
    tt = clip_grad_norm_(tps, 3.0, norm_type=norm_type)
    assert float(tt) == pytest.approx(float(np.asarray(jt._data)), rel=1e-6)
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.grad.numpy(), _f32(jp.grad._data),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# 6. the eager GradScaler loop and the guarded TrainStep
# ---------------------------------------------------------------------------

def test_eager_grad_scaler_loop_matches_jax():
    """scale -> backward -> step/update (and minimize) over a scripted
    overflow: parameters, and the scale after every step."""
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    y = rng.standard_normal((5, 3)).astype(np.float32)
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=2)
    jw = paddle.to_tensor(w0, stop_gradient=False)
    jw.name = "w"
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    jopt = popt.AdamW(learning_rate=0.01, parameters=[jw])
    topt_ = topt.AdamW(learning_rate=0.01, parameters=[tw])
    jsc, tsc = JScaler(**kw), GradScaler(**kw)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for i, k in enumerate((1.0, float("inf"), 1.0, 1.0, 1.0)):
        jl = ((paddle.matmul(jx, jw) - jy) ** 2).mean() * k
        tl = ((tx @ tw - ty) ** 2).mean() * k
        jsc.scale(jl).backward()
        tsc.scale(tl).backward()
        if i % 2:
            jsc.minimize(jopt, jl)
            tsc.minimize(topt_, tl)
        else:
            jsc.step(jopt)
            tsc.step(topt_)
            jsc.update()
            tsc.update()
            jopt.clear_grad()
            topt_.clear_grad()
        assert tsc.get_loss_scaling() == float(np.asarray(jsc._scale))
        np.testing.assert_allclose(tw.detach().numpy(), _f32(jw._data),
                                   rtol=1e-6, atol=1e-7)
    assert topt_._step_count == 4 and tsc.is_use_dynamic_loss_scaling()
    tsc.set_init_loss_scaling(4.0)
    assert tsc.get_loss_scaling() == 4.0


def test_unscale_returns_the_true_grads():
    w = torch.nn.Parameter(torch.ones(3, 2))
    opt = topt.SGD(learning_rate=0.1, parameters=[w])
    sc = GradScaler(init_loss_scaling=2.0 ** 10)
    sc.scale((w * torch.arange(6.0).reshape(3, 2)).sum()).backward()
    sc.unscale_(opt)
    assert torch.equal(w.grad, torch.arange(6.0).reshape(3, 2))
    assert not bool(sc._found_inf)


class _NoHostRead:
    """Inside the block, reading a tensor back to the host raises."""
    NAMES = ("item", "__bool__", "__float__", "__int__", "tolist",
             "numpy", "__index__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*_, **__):
            raise AssertionError("host read inside the guarded step")

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def _toy():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 3))
    x, y = torch.randn(4, 6), torch.randn(4, 3)
    return model, x, y


@pytest.mark.parametrize("opt_kind", ["adamw", "adamw_per_param",
                                      "momentum"])
@pytest.mark.parametrize("scaler", [False, True])
def test_guarded_train_step_makes_no_host_read(opt_kind, scaler):
    model, x, y = _toy()
    model[0].bfloat16()
    if opt_kind == "momentum":
        opt = topt.Momentum(learning_rate=0.1, parameters=model.parameters(),
                            multi_precision=True,
                            grad_clip=ClipGradByGlobalNorm(1.0))
    else:
        opt = topt.AdamW(learning_rate=0.1, parameters=model.parameters(),
                         multi_precision=True, moment_dtype="bfloat16",
                         grad_clip=ClipGradByGlobalNorm(1.0),
                         use_multi_tensor=opt_kind == "adamw")
    def loss_fn(m, a, b, k):
        h = torch.tanh(m[0](a.bfloat16())).float()
        return ((m[2](h) - b) ** 2).mean() * k

    step = TrainStep(
        model, loss_fn, opt,
        scaler=GradScaler(init_loss_scaling=64.0) if scaler else None,
        guard_nonfinite=True)
    one, inf = torch.tensor(1.0), torch.tensor(float("inf"))
    with _NoHostRead():
        step(x, y, one)
    before = [t.clone() for t in opt._state()]
    with _NoHostRead():
        loss = step(x, y, inf)
    assert not torch.isfinite(loss)
    after = list(opt._state())
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert opt._step_count == 1 and int(step.guard.skipped) == 1
    if scaler:
        assert step.guard.scaler.get_loss_scaling() == 32.0
    with _NoHostRead():
        step(x, y, one)
    assert opt._step_count == 2
    assert not torch.equal(model[2].weight, before[3])


# ---------------------------------------------------------------------------
# 7. p.grad after step(), and the guarded per-parameter step's selection
# ---------------------------------------------------------------------------

# every optimizer of the reference (the 12 others, and Adam / AdamW on the
# fused and the per-parameter path)
STEPPED = {**OTHERS,
           "Adam_fused": dict(cls="Adam", weight_decay=0.02),
           "Adam_per_param": dict(cls="Adam", weight_decay=0.02,
                                  use_multi_tensor=False),
           "AdamW_fused": dict(cls="AdamW"),
           "AdamW_per_param": dict(cls="AdamW", use_multi_tensor=False)}
# grad_clip objects of the two packages; "clip_grad_norm_" is the in-place
# utility called before step()
CLIP_KINDS = {
    "global_norm": lambda nn: nn.ClipGradByGlobalNorm(0.5),
    "norm": lambda nn: nn.ClipGradByNorm(0.5),
    "value": lambda nn: nn.ClipGradByValue(0.3),
    "clip_grad_norm_": None,
}


def _stepped(framework, name, arrays, clip):
    kw = dict(STEPPED[name])
    cls = kw.pop("cls", name)
    kw.setdefault("learning_rate", 0.01)
    jax_side = framework == "jax"
    ps = _jparams(arrays) if jax_side else _tparams(arrays)
    if jax_side:
        kw.pop("use_multi_tensor", None)
    make = CLIP_KINDS.get(clip)
    if make is not None:
        import paddle_tpu_torch.nn as tnn
        kw["grad_clip"] = make(jnn if jax_side else tnn)
    return ps, getattr(popt if jax_side else topt, cls)(parameters=ps, **kw)


@pytest.mark.parametrize("clip", list(CLIP_KINDS))
@pytest.mark.parametrize("name", list(STEPPED))
def test_grads_after_step_match_jax(name, clip):
    """``p.grad`` after ``step()`` is what the reference leaves: the grad
    as given under a clip object (its clipped copy feeds the update
    only), the clipped grad after ``clip_grad_norm_``; the parameters
    follow the reference's."""
    arrays = _init(7)
    jps, jopt = _stepped("jax", name, arrays, clip)
    tps, topt_ = _stepped("torch", name, arrays, clip)
    for step in range(2):
        gs = _grads(step, scale=2.0, seed=400)
        _set_grads(jps, tps, gs)
        if clip == "clip_grad_norm_":
            jnn.clip.clip_grad_norm_(jps, 1.0)
            clip_grad_norm_(tps, 1.0)
        jopt.step()
        topt_.step()
        for i, (tp, jp, g) in enumerate(zip(tps, jps, gs)):
            np.testing.assert_allclose(tp.grad.numpy(), _f32(jp.grad._data),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {clip} w{i}")
            if clip != "clip_grad_norm_":
                np.testing.assert_array_equal(tp.grad.numpy(), g)
    for i, (tp, jp) in enumerate(zip(tps, jps)):
        np.testing.assert_allclose(tp.detach().numpy(), _f32(jp._data),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {clip} w{i}")


def _old_gated_step(opt):
    """The guarded step as the per-parameter path ran it before: snapshot
    every tensor of the state, run the plain step, select it all back
    where a grad was not finite (state must exist already)."""
    pg = opt._params_grads()
    _, found = mt.multi_tensor_norm([g for _, g in pg])
    snap = [(t, t.clone()) for t in opt._state()]
    opt._run_step(pg)
    for live, old in snap:
        live.copy_(torch.where(found, old, live))
    return found


# the 12 other optimizers (14 configurations) and the per-parameter Adam
GATED = [n for n in STEPPED if not n.endswith("_fused")]


def _gated_run(name, clip, step_fn, skip_at, steps=4):
    arrays = _init(8)
    ps, opt = _stepped("torch", name, arrays, clip)
    for step in range(steps):
        gs = _grads(step, scale=1.5, seed=500)
        if step == skip_at:
            gs[2][1, 3] = np.inf
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        step_fn(opt)
    return ps, opt


@pytest.mark.parametrize("clip", ["global_norm", None])
@pytest.mark.parametrize("name", GATED)
def test_guarded_per_parameter_step_equals_the_whole_state_snapshot(name,
                                                                    clip):
    """Guarded steps with an inf at step 2 of 4 select each parameter's
    state back right after its update: every parameter, master and
    accumulator, and the count, bit for bit the old whole-state
    snapshot's."""
    new_ps, new = _gated_run(name, clip, lambda o: o._guarded_step(), 2)
    old_ps, old = _gated_run(name, clip, _old_gated_step, 2)
    assert new._step_count == old._step_count == 3
    for a, b in zip(new_ps, old_ps):
        assert torch.equal(a, b)
    for store_name, store in new._accumulators.items():
        for (ka, a), (kb, b) in zip(store.items(), old._accumulators[
                store_name].items()):
            assert torch.equal(a, b), (name, store_name)


@pytest.mark.parametrize("name", GATED)
def test_guarded_skip_of_the_first_step_leaves_fresh_state(name):
    """A first step skipped (an inf grad) while its update creates the
    accumulators leaves them at their initial values: the next steps
    match an optimizer that never took the skipped one, bit for bit."""
    ps, opt = _gated_run(name, "global_norm", lambda o: o._guarded_step(),
                         0, steps=3)
    arrays = _init(8)
    ref_ps, ref = _stepped("torch", name, arrays, "global_norm")
    for step in (1, 2):
        for p, g in zip(ref_ps, _grads(step, scale=1.5, seed=500)):
            p.grad = torch.from_numpy(g)
        ref._guarded_step()
    assert opt._step_count == ref._step_count == 2
    for a, b in zip(ps, ref_ps):
        assert torch.equal(a, b)
