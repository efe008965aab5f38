"""The training slice of the PyTorch port against the JAX package.

Weights are drawn with numpy from a seed, set on the reference model and
carried into the port by `convert.state_dict_from_jax`; batches are numpy
arrays handed to both. On CPU tensors the port runs its kernels' plain
versions. Bars:

* `GPTForCausalLM.loss` within 1e-5 and every parameter gradient within
  1e-4 of the gradient's largest magnitude (fp32, the same algorithm);
* 5 `TrainStep`s (AdamW, clip 1.0): loss |diff| < 5e-4 each step and
  parameters relative < 5e-3 at the end, the reference's own bars for
  two training paths (tests/test_training_kernels.py);
* bf16 weights + fp32 masters + bf16 moments, 3 steps: loss |diff| <
  2e-2 and every parameter element within 2 * lr a step plus one bf16
  ulp (bf16 rounds at other places in the two frameworks, and Adam
  turns a gradient of rounding noise into a step of about lr);
* the non-finite guard and AdamW's decay rule exactly.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.amp import decorate as jdecorate
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit.nonfinite_guard import GuardSpec as JGuardSpec
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import GradScaler, auto_cast, decorate
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.nonfinite_guard import GuardSpec, all_finite
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def make_models(seed=0, **over):
    """(reference model, port model), the same numpy weights, both in
    training mode."""
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


def batch(b=2, s=64, seed=1, segments=False, mask=False):
    rng = np.random.default_rng(seed)
    out = {"ids": rng.integers(0, TINY["vocab_size"], (b, s)),
           "labels": rng.integers(0, TINY["vocab_size"], (b, s))}
    out["labels"][0, ::7] = -100
    if segments:
        out["seg"] = np.stack([np.repeat([0, 1, 2], [20, 30, s - 50]),
                               np.zeros(s, np.int64)]).astype(np.int32)
    if mask:
        out["mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    return out


def _jax_args(bt):
    return dict(
        input_ids=paddle.to_tensor(bt["ids"], dtype="int64"),
        labels=paddle.to_tensor(bt["labels"], dtype="int64"),
        loss_mask=(paddle.to_tensor(bt["mask"]) if "mask" in bt else None),
        segment_ids=(paddle.to_tensor(bt["seg"], dtype="int32")
                     if "seg" in bt else None))


def _port_args(bt):
    return dict(
        input_ids=torch.from_numpy(bt["ids"]),
        labels=torch.from_numpy(bt["labels"]),
        loss_mask=(torch.from_numpy(bt["mask"]) if "mask" in bt else None),
        segment_ids=(torch.from_numpy(bt["seg"]) if "seg" in bt else None))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jax_params(jm):
    """The reference's parameters in the port's layout (fp32 numpy)."""
    return {k: v.float().numpy() for k, v in convert.state_dict_from_jax(
        {n: np.asarray(p._data.astype(jnp.float32))
         for n, p in jm.named_parameters()}).items()}


def _port_params(tm):
    return {n: p.detach().float().numpy() for n, p in tm.named_parameters()}


# ---------------------------------------------------------------------------
# 1. the loss and every gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied,segments,mask,recompute", [
    (True, False, False, False), (True, True, False, False),
    (True, False, True, True), (True, True, True, True),
    (False, False, False, False), (False, True, True, True)])
def test_loss_and_grads_match_jax(tied, segments, mask, recompute):
    jm, tm = make_models(tie_word_embeddings=tied, use_recompute=recompute)
    bt = batch(segments=segments, mask=mask)
    jl = jm.loss(**_jax_args(bt))
    jl.backward()
    tl = tm.loss(**_port_args(bt))
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    jgrads = convert.state_dict_from_jax(
        {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()})
    for name, p in tm.named_parameters():
        rel = _rel(p.grad.numpy(), jgrads[name].numpy())
        assert rel < 1e-4, (name, rel)


def test_loss_equals_the_criterion_over_logits():
    """`loss` (fused head) equals `GPTPretrainingCriterion` over the
    materialised logits, with and without a loss mask."""
    from paddle_tpu_torch.models import GPTPretrainingCriterion

    _, tm = make_models()
    crit = GPTPretrainingCriterion()
    for bt in (batch(), batch(mask=True, segments=True)):
        a = _port_args(bt)
        with torch.no_grad():
            fused = tm.loss(**a)
            dense = crit(tm(a["input_ids"], segment_ids=a["segment_ids"]),
                         a["labels"], a["loss_mask"])
        assert abs(float(fused) - float(dense)) < 1e-5


def test_recompute_replays_the_block_forward():
    """With use_recompute each block's forward runs again in the
    backward: twice the attention forwards of a plain step (64 tokens,
    under ``FLAGS_pallas_flash_min_seqlen``: the dense attention), the
    same gradients."""
    import importlib

    sdpa = importlib.import_module(
        "paddle_tpu_torch.nn.functional.flash_attention")
    calls = []
    orig = sdpa._sdpa_ref

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    bt = _port_args(batch())
    grads = []
    for recompute in (False, True):
        _, tm = make_models(use_recompute=recompute)
        calls.clear()
        sdpa._sdpa_ref = counting
        try:
            tm.loss(bt["input_ids"], bt["labels"]).backward()
        finally:
            sdpa._sdpa_ref = orig
        grads.append([p.grad for p in tm.parameters()])
        assert len(calls) == TINY["num_layers"] * (2 if recompute else 1)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# 2. the training step
# ---------------------------------------------------------------------------

def _trajectory(acc, steps=5, port_args=None):
    """5 AdamW steps of both packages; ``port_args`` builds the port's
    `TrainStep` from (model, loss_fn, optimizer) instead of
    ``accum_steps=acc``."""
    jm, tm = make_models()
    bt = batch(b=4, s=32, seed=2)
    jopt = popt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                      parameters=jm.parameters(), grad_clip=JClip(1.0))
    jstep = JTrainStep(jm, lambda m, x, y: m.loss(x, y), jopt,
                       accumulate_steps=acc)
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    loss_fn = lambda m, x, y: m.loss(x, y)  # noqa: E731
    tstep = (TrainStep(tm, loss_fn, topt, accum_steps=acc)
             if port_args is None else port_args(tm, loss_fn, topt))
    ja = [paddle.to_tensor(bt[k], dtype="int64") for k in ("ids", "labels")]
    ta = [torch.from_numpy(bt[k]) for k in ("ids", "labels")]
    jl = [float(jstep(*ja)) for _ in range(steps)]
    tl = [float(tstep(*ta)) for _ in range(steps)]
    return jm, tm, jl, tl, topt


@pytest.mark.parametrize("acc", [1, 2])
def test_train_step_trajectory_matches_jax(acc):
    jm, tm, jl, tl, topt = _trajectory(acc)
    assert max(abs(a - b) for a, b in zip(jl, tl)) < 5e-4, (jl, tl)
    assert tl[-1] < tl[0]
    assert topt._step_count == 5
    want = _jax_params(jm)
    for name, got in _port_params(tm).items():
        assert _rel(got, want[name]) < 5e-3, name


@pytest.mark.parametrize("form", ["accumulate_steps", "positional"])
def test_train_step_takes_the_reference_signature(form):
    """The reference's order and names: the fourth positional argument is
    ``donate`` (accepted, the state is updated in place) and
    ``accumulate_steps`` the micro-batch count; the trajectory holds the
    repo's bars against the reference's."""
    build = {
        "accumulate_steps": lambda m, f, o: TrainStep(
            m, f, o, donate=True, accumulate_steps=2),
        "positional": lambda m, f, o: TrainStep(m, f, o, False, 2),
    }[form]
    jm, tm, jl, tl, topt = _trajectory(2, port_args=build)
    assert max(abs(a - b) for a, b in zip(jl, tl)) < 5e-4, (jl, tl)
    want = _jax_params(jm)
    for name, got in _port_params(tm).items():
        assert _rel(got, want[name]) < 5e-3, name


def test_train_step_accum_steps_overrides_and_numerics_waits_for_a7():
    _, tm = make_models()
    opt = AdamW(parameters=tm.parameters())
    loss_fn = lambda m, x, y: m.loss(x, y)  # noqa: E731
    assert TrainStep(tm, loss_fn, opt, accum_steps=4).accumulate_steps == 4
    assert TrainStep(tm, loss_fn, opt, accumulate_steps=4,
                     accum_steps=4).accumulate_steps == 4
    with pytest.raises(ValueError, match="conflicting"):
        TrainStep(tm, loss_fn, opt, accumulate_steps=2, accum_steps=4)
    # the numerics monitor, ported since: on by default, one row a
    # parameter; numerics=False leaves it out
    on = TrainStep(tm, loss_fn, opt, numerics=True)
    assert on.numerics.rows == len(list(tm.parameters()))
    assert TrainStep(tm, loss_fn, opt).numerics is not None
    assert TrainStep(tm, loss_fn, opt, numerics=False).numerics is None


def test_train_step_accum_divisibility_errors():
    _, tm = make_models()
    opt = AdamW(parameters=tm.parameters())
    step = TrainStep(tm, lambda m, x, y: m.loss(x, y), opt, accum_steps=2)
    ids = torch.zeros(3, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible"):
        step(ids, ids)
    with pytest.raises(ValueError, match="one shared dim-0 size"):
        step(torch.zeros(4, 8, dtype=torch.long), ids)


def _bf16_pair(decorated):
    jm, tm = make_models(seed=3)
    jopt = popt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                      moment_dtype="bfloat16",
                      grad_clip=JClip(1.0))
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                 moment_dtype="bfloat16",
                 grad_clip=ClipGradByGlobalNorm(1.0))
    if decorated:
        jdecorate(models=jm, optimizers=jopt, level="O2")
        decorate(models=tm, optimizers=topt, level="O2")
    else:
        # bench.py's layout: everything bf16, LayerNorm included
        jm.bfloat16()
        tm.bfloat16()
        jopt._multi_precision = True
        topt._multi_precision = True
    return jm, tm, jopt, topt


@pytest.mark.parametrize("decorated", [False, True])
def test_bf16_masters_and_bf16_moments_match_jax(decorated):
    """bf16 parameters with fp32 masters and bf16 moments, both as
    bench.py lays them out (all bf16) and after amp.decorate(O2)
    (LayerNorm fp32, bf16 activations through it)."""
    jm, tm, jopt, topt = _bf16_pair(decorated)
    ln = tm.gpt.ln_f.weight
    assert ln.dtype == (torch.float32 if decorated else torch.bfloat16)
    assert tm.gpt.wte.weight.dtype == torch.bfloat16
    bt = batch(seed=4)
    jstep = JTrainStep(jm, lambda m, x, y: m.loss(x, y), jopt)
    tstep = TrainStep(tm, lambda m, x, y: m.loss(x, y), topt)
    ja = [paddle.to_tensor(bt[k], dtype="int64") for k in ("ids", "labels")]
    ta = [torch.from_numpy(bt[k]) for k in ("ids", "labels")]
    jl = [float(jstep(*ja)) for _ in range(3)]
    tl = [float(tstep(*ta)) for _ in range(3)]
    assert all(np.isfinite(tl))
    assert max(abs(a - b) for a, b in zip(jl, tl)) < 2e-2, (jl, tl)
    # Adam moves an element by about lr a step whatever its gradient, so
    # where the gradient is rounding noise on both sides (the key bias's
    # is 0 in exact arithmetic) the two runs may step apart: each element
    # within 2 * lr a step, plus one bf16 ulp of the tensor's scale
    want = _jax_params(jm)
    for name, got in _port_params(tm).items():
        w = want[name]
        bar = 2 * 1e-3 * len(tl) + 2.0 ** -8 * np.abs(w).max()
        assert np.abs(got - w).max() <= bar, name
    wte = tm.gpt.wte.weight
    master = topt._master_weights[wte]
    assert master.dtype == torch.float32
    assert torch.equal(master.to(torch.bfloat16), wte.detach())
    m1 = topt._accumulators["moment1"][wte]
    assert m1.dtype == torch.bfloat16
    assert ln not in topt._master_weights if decorated else True


def test_masters_start_from_the_bf16_parameter():
    """The fp32 master is made at the first step from the bf16 parameter
    itself (upcast), not from any earlier fp32 copy."""
    _, tm = make_models()
    fp32_wte = tm.gpt.wte.weight.detach().clone()
    tm.bfloat16()
    opt = AdamW(learning_rate=0.0, weight_decay=0.0,
                parameters=tm.parameters(), multi_precision=True)
    assert not opt._master_weights
    tm.loss(**_port_args(batch())).backward()
    opt.step()
    master = opt._master_weights[tm.gpt.wte.weight]
    assert torch.equal(master, fp32_wte.to(torch.bfloat16).float())
    assert not torch.equal(master, fp32_wte)


def test_clip_matches_jax_and_keeps_dtypes():
    rng = np.random.default_rng(5)
    shapes = [(8, 4), (4,), (3, 5)]
    gs = [(rng.standard_normal(s) * 3).astype(np.float32) for s in shapes]
    params = [torch.zeros(s) for s in shapes]
    params[2].need_clip = False
    tg = [torch.from_numpy(g.copy()) for g in gs]
    tout = ClipGradByGlobalNorm(1.0)(list(zip(params, tg)))
    jparams = [paddle.to_tensor(np.zeros(s, np.float32)) for s in shapes]
    jparams[2].need_clip = False
    out = JClip(1.0)(list(zip(jparams, [paddle.to_tensor(g) for g in gs])))
    for (_, t), (_, j) in zip(tout, out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j._data), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(tout[2][1].numpy(), gs[2])
    # new grads, as the reference returns: the caller's stay as they were
    for t, g in zip(tg, gs):
        np.testing.assert_array_equal(t.numpy(), g)
    bf = torch.from_numpy(gs[0]).bfloat16()
    (_, bf_out), = ClipGradByGlobalNorm(1.0)([(params[0], bf)])
    assert bf_out.dtype == torch.bfloat16
    assert abs(float(bf_out.float().norm()) - 1.0) < 1e-2
    assert torch.equal(bf, torch.from_numpy(gs[0]).bfloat16())


# ---------------------------------------------------------------------------
# 3. the guard and the loss scale
# ---------------------------------------------------------------------------

def _snapshot(model, opt):
    return {
        "params": [p.detach().clone() for p in model.parameters()],
        "masters": [m.clone() for m in opt._master_weights.values()],
        "moments": [t.clone() for store in opt._accumulators.values()
                    for t in store.values()],
        "step": opt._step_count,
    }


def test_guard_skips_a_non_finite_step_bit_identically():
    _, tm = make_models()
    tm.bfloat16()
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                multi_precision=True, moment_dtype="bfloat16",
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(tm, lambda m, x, y, k: m.loss(x, y) * k, opt,
                     guard_nonfinite=True)
    bt = batch()
    ids, labels = torch.from_numpy(bt["ids"]), torch.from_numpy(bt["labels"])
    step(ids, labels, torch.tensor(1.0))
    before = _snapshot(tm, opt)
    assert before["masters"] and before["moments"]
    loss = step(ids, labels, torch.tensor(float("inf")))
    assert not torch.isfinite(loss)
    after = _snapshot(tm, opt)
    assert after["step"] == before["step"] == 1
    for key in ("params", "masters", "moments"):
        assert all(torch.equal(a, b)
                   for a, b in zip(after[key], before[key])), key
    assert all(p.grad is None for p in tm.parameters())
    assert int(step.guard.skipped) == 1
    step(ids, labels, torch.tensor(1.0))
    assert opt._step_count == 2
    assert not torch.equal(tm.gpt.wte.weight, before["params"][0])


def test_all_finite():
    assert bool(all_finite([torch.ones(3), torch.zeros(2, 2)]))
    assert not bool(all_finite([torch.ones(3),
                                torch.tensor([1.0, float("nan")])]))
    assert not bool(all_finite([torch.tensor([float("-inf")]).bfloat16()]))
    assert bool(all_finite([torch.ones(2, dtype=torch.long), None]))


@pytest.mark.parametrize("dynamic", [True, False])
def test_guard_update_rule_matches_jax(dynamic):
    kw = dict(init_loss_scaling=64.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2,
              use_dynamic_loss_scaling=dynamic)
    tg, jg = GuardSpec(GradScaler(**kw)), JGuardSpec(JScaler(**kw))
    ts, js = tg.init_state("cpu"), jg.init_state()
    script = [False, True, False, False, False, True, True, True, False,
              True, True, True, True, True, True, True, True]
    for found in script:
        ts = tg.update(ts, torch.tensor(found))
        js = jg.update(js, jnp.asarray(found))
        for key in ("scale", "good", "bad", "found", "skipped"):
            assert float(ts[key]) == float(np.asarray(js[key])), (key, found)
    assert float(ts["scale"]) >= 1.0


def test_loss_scaled_steps_match_jax():
    """TrainStep with a bound GradScaler over a scripted bad step: the
    losses, the scale after every step and the final parameters follow
    the reference's compiled step."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    jm, tm = make_models(seed=6)
    jopt = popt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                      grad_clip=JClip(1.0))
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    jsc, tsc = JScaler(**kw), GradScaler(**kw)
    jstep = JTrainStep(jm, lambda m, x, y, k: m.loss(x, y) * k, jopt,
                       scaler=jsc)
    tstep = TrainStep(tm, lambda m, x, y, k: m.loss(x, y) * k, topt,
                      scaler=tsc)
    bt = batch(seed=7)
    ja = [paddle.to_tensor(bt[k], dtype="int64") for k in ("ids", "labels")]
    ta = [torch.from_numpy(bt[k]) for k in ("ids", "labels")]
    for k in (1.0, float("inf"), 1.0, 1.0, 1.0):
        jl = float(jstep(*ja, paddle.to_tensor(np.float32(k))))
        tl = float(tstep(*ta, torch.tensor(k)))
        if np.isfinite(jl):
            assert abs(jl - tl) < 5e-4
        else:
            assert not np.isfinite(tl)
        assert tsc.get_loss_scaling() == float(np.asarray(jsc._scale))
    assert tsc.state_dict()["scale"] == 1024.0   # halved, then doubled
    assert topt._step_count == int(jopt._step_count) == 4
    want = _jax_params(jm)
    for name, got in _port_params(tm).items():
        assert _rel(got, want[name]) < 5e-3, name


# ---------------------------------------------------------------------------
# 4. the optimizer's decay rule, AMP and the refused configurations
# ---------------------------------------------------------------------------

def test_adamw_decays_every_parameter_by_default():
    """Decoupled decay reaches biases, LayerNorm weights and the
    embeddings unless apply_decay_param_fun excludes them: with zero
    grads the Adam term is 0 and p becomes p * (1 - lr * wd) exactly."""
    lr, wd = 0.1, 0.5
    for fun in (None, lambda name: not name.endswith("bias")):
        _, tm = make_models()
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        opt = AdamW(learning_rate=lr, weight_decay=wd,
                    parameters=tm.named_parameters(),
                    apply_decay_param_fun=fun)
        for p in tm.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        for name, p in tm.named_parameters():
            decays = fun is None or fun(name)
            want = before[name] * (1 - lr * wd) if decays else before[name]
            assert torch.equal(p.detach(), want), name
    assert "gpt.ln_f.bias" in before and "gpt.wpe.weight" in before


def test_adam_update_matches_jax_adam_math():
    """One AdamW update of a fp32 parameter against the reference's
    `_adam_math`, decay included, at step 3."""
    rng = np.random.default_rng(8)
    p0, g, m, v = (rng.standard_normal(50).astype(np.float32)
                   for _ in range(4))
    v = np.abs(v)
    jopt = popt.AdamW(learning_rate=0.01,
                      parameters=[paddle.to_tensor(p0)])
    want, wm, wv, _ = jopt._adam_math(jnp.asarray(p0), jnp.asarray(g),
                                      jnp.asarray(m), jnp.asarray(v), None,
                                      0.01, 3, 0.01)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = AdamW(learning_rate=0.01, parameters=[p])
    opt._get_accumulator("moment1", p).copy_(torch.from_numpy(m))
    opt._get_accumulator("moment2", p).copy_(torch.from_numpy(v))
    opt._step_count = 2
    p.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt._accumulators["moment1"][p].numpy(),
                               np.asarray(wm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt._accumulators["moment2"][p].numpy(),
                               np.asarray(wv), rtol=1e-6, atol=1e-7)


def test_decorate_o2_and_auto_cast():
    _, tm = make_models()
    opt = AdamW(parameters=tm.parameters())
    model, opt2 = decorate(models=tm, optimizers=opt, level="O2")
    assert model is tm and opt2 is opt and opt._multi_precision
    assert tm.gpt.blocks[0].ln_1.weight.dtype == torch.float32
    assert tm.gpt.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert tm.gpt.wpe.weight.dtype == torch.bfloat16
    with auto_cast(level="O2"):
        pass
    with pytest.raises(NotImplementedError, match="A2"):
        with auto_cast(level="O1"):
            pass


@pytest.mark.parametrize("field,value", [
    ("scan_layers", True), ("recompute_policy", "dots"),
    ("num_experts", 4), ("use_ring_attention", True),
    ("num_draft_heads", 2)])
def test_config_refuses_what_later_slices_own(field, value):
    if field == "num_draft_heads":
        # ported since (ROADMAP A6): the heads exist, zero-initialised
        cfg = GPTConfig(**{**TINY, field: value})
        assert cfg.num_draft_heads == 2 and cfg.draft_head_loss_weight == 0.1
        heads = GPTForCausalLM(cfg, device="cpu").draft_heads
        assert len(heads) == 2
        assert all((p == 0).all() for p in heads.parameters())
        return
    if field == "num_experts":
        # ported since (ROADMAP A9b.3): every block's MLP is an MoEBlock
        # under the reference's names, its defaults the reference's
        cfg = GPTConfig(**{**TINY, field: value})
        assert (cfg.moe_capacity_factor, cfg.moe_gate,
                cfg.moe_aux_weight) == (2.0, "gshard", 1e-2)
        tm = GPTForCausalLM(cfg, device="cpu")
        assert tuple(tm.gpt.blocks[1].mlp.moe.experts__fc1__weight.shape) \
            == (4, TINY["hidden_size"], 4 * TINY["hidden_size"])
        ids = torch.randint(0, TINY["vocab_size"], (2, 8))
        assert torch.isfinite(tm.loss(ids, ids)) and \
            tm.gpt.moe_aux() is not None
        return
    if field == "use_ring_attention":
        # ported since (ROADMAP A9b.5): accepted; at a world of one (no
        # sep group) the model is the dense one, as the reference's
        cfg = GPTConfig(**{**TINY, field: value})
        ring, plain = (GPTForCausalLM(c, device="cpu", seed=3)
                       for c in (cfg, GPTConfig(**TINY)))
        ids = torch.randint(0, TINY["vocab_size"], (2, 8))
        torch.testing.assert_close(ring(ids), plain(ids), rtol=0, atol=0)
        return
    if field in ("scan_layers", "recompute_policy"):
        # ported since (ROADMAP A7): accepted, and a policy the reference
        # does not know is refused as there
        assert getattr(GPTConfig(**{**TINY, field: value}), field) == value
        with pytest.raises(ValueError, match="recompute policy"):
            GPTConfig(**{**TINY, "recompute_policy": "everything"})
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue"):
        GPTConfig(**{**TINY, field: value})
