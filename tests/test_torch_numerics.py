"""The training-numerics monitor of the PyTorch port
(`observability.numerics`) against the JAX package's.

* `TrainStep`'s per-parameter stats block against the reference
  `TrainStep`'s for the same steps: 1e-4 relative (fp32; 1e-3 for the
  update norm of qkv.bias, a third of whose grad is rounding noise), the
  bad-grad field exactly (the fused step's block is held in
  tests/test_torch_fused_scan.py, where the reference's fused step is
  built once);
* both monitors fed the same numpy blocks agree exactly on
  ``summary()``, ``provenance()`` and ``anomalies()`` (the cases of
  tests/test_numerics.py: the spike detector, its warm-up, non-finite
  steps and the provenance rules);
* the monitor never reads a block back in ``on_step``, and a step with
  it reads nothing back either.
"""
import math

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
from paddle_tpu.observability import numerics as jnum
from paddle_tpu_torch import convert, set_flags
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import FusedScanTrainStep, TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import numerics as tnum
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=96, hidden_size=32, num_layers=2,
            num_attention_heads=2, max_position_embeddings=16)


class _NoHostRead:
    """Inside the block, reading a tensor back to the host raises (as in
    tests/test_torch_optimizer.py)."""
    NAMES = ("item", "__bool__", "__float__", "__int__", "tolist",
             "numpy", "__index__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*_, **__):
            raise AssertionError("host read")

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


def _models():
    paddle.seed(0)
    jm = JModel(JConfig(**TINY))
    rng = np.random.default_rng(0)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        a = 1.0 + 0.1 * a if "ln" in name and name.endswith("weight") \
            else 0.1 * a
        p._data = jnp.asarray(a)
        named[name] = a
    tm = GPTForCausalLM(GPTConfig(**TINY), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    return jm, tm


def test_train_step_stats_blocks_match_the_reference():
    """3 AdamW steps with a global-norm clip; the third's grads are NaN in
    one parameter's rows (an inf loss multiplier): per-parameter rows in
    ``named_parameters()`` order, the same finite fields within 1e-4
    relative, the bad-grad field exactly."""
    jm, tm = _models()
    jopt = popt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                      grad_clip=JClip(1.0))
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    jstep = JTrainStep(jm, lambda m, x, y, k: m.loss(x, y) * k, jopt,
                       numerics=True)
    tstep = TrainStep(tm, lambda m, x, y, k: m.loss(x, y) * k, topt,
                      numerics=True)
    noise = [i for i, (n, _) in enumerate(tm.named_parameters())
             if n.endswith("qkv.bias")]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY["vocab_size"], (2, 16))
    labels = rng.integers(0, TINY["vocab_size"], (2, 16))
    for k in (1.0, 1.0, float("inf")):
        jstep(paddle.to_tensor(ids, dtype="int64"),
              paddle.to_tensor(labels, dtype="int64"),
              paddle.to_tensor(np.float32(k)))
        tstep(torch.from_numpy(ids), torch.from_numpy(labels),
              torch.tensor(k))
        want = np.asarray(jstep._numerics._pending[-1][1], np.float64)
        got = tstep.numerics._pending[-1][1][0]
        assert got.shape == want.shape == (len(list(tm.parameters())), 8)
        assert np.array_equal(np.isfinite(got), np.isfinite(want)), k
        assert np.array_equal(got[:, tnum.F_GRAD_BAD],
                              want[:, tnum.F_GRAD_BAD])
        # the key third of qkv.bias has a zero grad in exact arithmetic
        # (softmax ignores a shift of every score of a row): Adam turns
        # its rounding noise, which the two packages round apart, into a
        # step of about lr, so that row's update norm holds 1e-3
        bar = np.full(want.shape, 1e-4)
        bar[noise, tnum.F_UPD_SQ] = 1e-3
        fin = np.isfinite(want)
        err = np.abs(got[fin] - want[fin])
        assert (err <= bar[fin] * np.maximum(np.abs(want[fin]), 1e-30)) \
            .all(), k
    assert want[:, tnum.F_GRAD_BAD].all()
    js, ts = jstep._numerics.summary(), tstep.numerics.summary()
    assert ts["finite_frac"] == js["finite_frac"] == 2 / 3
    assert ts["steps_seen"] == js["steps_seen"] == 3


def test_update_ratio_is_the_actual_step():
    """The reference's check: each row's update ratio is ‖Δw‖ / ‖w‖ of
    the step the optimizer took (a zero-init bias pins 0)."""
    torch.manual_seed(0)
    m = torch.nn.Linear(16, 8)
    with torch.no_grad():
        m.bias.zero_()
    opt = AdamW(learning_rate=1e-2, parameters=m.parameters())
    step = TrainStep(m, lambda mm, a, b: ((mm(a) - b) ** 2).mean(), opt)
    before = [p.detach().double().clone() for p in m.parameters()]
    step(torch.randn(4, 16), torch.randn(4, 8))
    after = [p.detach().double() for p in m.parameters()]
    rows = step.numerics.latest_rows()
    assert [r["label"] for r in rows] == ["weight", "bias"]
    for r, b, a in zip(rows, before, after):
        p_norm = float(b.norm())
        if p_norm == 0.0:
            assert r["update_ratio"] == 0.0
            continue
        want = float((a - b).norm()) / p_norm
        assert abs(r["update_ratio"] - want) <= 1e-3 * want


def _stats(grad_norms):
    rows = np.zeros((len(grad_norms), tnum.NFIELDS), np.float32)
    rows[:, tnum.F_GRAD_SQ] = np.square(grad_norms)
    rows[:, tnum.F_PARAM_SQ] = 1.0
    return rows


def _spike():
    rng = np.random.default_rng(0)
    seq = [_stats(1.0 + 0.01 * rng.standard_normal(3)) for _ in range(20)]
    return seq + [_stats(np.array([1.0, 100.0, 1.0]))]


def _nonfinite():
    bad = np.zeros((3, tnum.NFIELDS), np.float32)
    bad[:, tnum.F_GRAD_SQ] = np.float32("nan")
    bad[1, tnum.F_GRAD_BAD] = 1.0
    return [_stats([1.0, 1.0, 1.0])] * 6 + [bad, _stats([1.0, 1.0, 1.0])]


def _forward_origin():
    rows = np.zeros((4, tnum.NFIELDS), np.float32)
    rows[:, tnum.F_GRAD_SQ] = np.float32("nan")
    rows[:3, tnum.F_GRAD_BAD] = 1.0
    rows[2, tnum.F_ACT_ORIGIN] = 1.0
    rows[:, tnum.F_ACT_SQ] = 2.0
    rows[:, tnum.F_ACT_N] = 8.0
    return [rows]


def _backward_highest():
    rows = np.zeros((4, tnum.NFIELDS), np.float32)
    rows[:3, tnum.F_GRAD_BAD] = 1.0
    return [rows]


FEEDS = {  # name: (blocks, monitor keywords)
    "spike fires on a 100x grad norm": (_spike(), dict(warmup=5)),
    "warm-up gates the detector": (
        [_stats([1.0, 1.0, 1.0])] * 3 + [_stats([1.0, 500.0, 1.0])],
        dict(warmup=10)),
    "non-finite steps do not poison the EWMA": (_nonfinite(),
                                                dict(warmup=2)),
    "forward origin wins": (_forward_origin(), {}),
    "backward contamination picks the highest": (_backward_highest(), {}),
}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_monitors_agree_on_the_same_blocks(feed):
    blocks, kw = FEEDS[feed]
    rows = blocks[0].shape[0]
    kw = dict(kw, ewma_alpha=0.2, z_threshold=8.0)
    labels = [f"chunk{i}" for i in range(rows - 1)] + ["outer"]
    j = jnum.NumericsMonitor("Step", rows, row_labels=labels, **kw)
    t = tnum.NumericsMonitor("Step", rows, row_labels=labels, **kw)
    for i, b in enumerate(blocks):
        j.on_step(jnp.asarray(b), step=i)
        t.on_step(torch.from_numpy(b.copy()), step=i)
    js, ts = j.summary(), t.summary()
    assert js.keys() == ts.keys()
    for k in js:
        assert (js[k] == ts[k]) or (isinstance(js[k], float)
                                    and math.isnan(js[k])
                                    and math.isnan(ts[k])), k
    assert j.provenance() == t.provenance()
    assert j.anomalies() == t.anomalies()
    assert j.latest_rows() == t.latest_rows()
    if feed.startswith("spike"):
        assert t.anomalies()[-1]["chunk"] == 1
    if "origin" in feed:
        assert ts["first_bad_chunk"] == 2
        assert t.provenance()["origin"] == "activation"


def test_on_step_reads_nothing_and_folds_the_oldest_when_full():
    mon = tnum.NumericsMonitor("t", 2, ring=8)
    blocks = [torch.from_numpy(_stats([1.0, float(i + 1)]))
              for i in range(12)]
    with _NoHostRead():
        for b in blocks[:8]:
            mon.on_step(b)
        assert len(mon._pending) == 8 and mon._steps_seen == 0
        for b in blocks[8:]:
            mon.on_step(b)        # full: the oldest is folded, not dropped
        assert mon._steps_seen == 4
    assert mon.summary()["steps_seen"] == 12
    assert [e["step"] for e in mon.history()][-1] == 11


@pytest.mark.parametrize("fused", [False, True])
def test_steps_past_the_ring_make_no_host_read(fused):
    """Steps past the monitor's queue (its depth cut from 64 to 8 to keep
    the test short; the card test and chip_smoke.py phase 13 run 70 steps
    at 64): from then on each call folds the oldest block inside the
    step, from the host copy made when it was queued, and reads nothing
    back from a tensor."""
    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=fused), device="cpu",
                        seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    if fused:
        step = FusedScanTrainStep(tm, opt, numerics=True)
        mon = step._numerics = tnum.NumericsMonitor(
            "FusedScanTrainStep", step._numerics.rows, ring=8)
    else:
        step = TrainStep(tm, lambda m, x, y: m.loss(x, y), opt,
                         numerics=True)
        mon = step.numerics = tnum.NumericsMonitor(
            "TrainStep", step.numerics.rows, ring=8)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 96, (2, 16)))
    with _NoHostRead():
        for _ in range(12):
            step(ids, ids)
        assert mon._steps_seen == 12 - 8 and len(mon._pending) == 8
    s = mon.summary()
    assert s["steps_seen"] == 12 and s["finite_frac"] == 1.0
    assert opt._step_count == 12


def test_lazy_gauges_and_payload():
    _, tm = _models()
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    step = TrainStep(tm, lambda m, x, y: m.loss(x, y), opt)
    ids = torch.zeros(2, 16, dtype=torch.long)
    step(ids, ids)
    reg = registry()
    gn = reg.gauge("numerics.global_grad_norm").value
    assert gn == step.numerics.summary()["grad_norm"] > 0
    assert reg.gauge("numerics.finite_frac").value == 1.0
    assert reg.gauge("numerics.first_bad_chunk").value == -1
    p = step.numerics.payload()
    assert p["name"] == "TrainStep" and len(p["per_chunk"]) == p["rows"]
    assert "numerics_global_grad_norm" in reg.expose()


def test_monitor_follows_the_flag_and_the_kill_switch(monkeypatch):
    _, tm = _models()
    opt = AdamW(parameters=tm.parameters())
    fn = lambda m, x, y: m.loss(x, y)  # noqa: E731
    assert tnum.monitor_enabled()
    set_flags({"FLAGS_numerics_monitor": False})
    try:
        assert TrainStep(tm, fn, opt).numerics is None
        assert TrainStep(tm, fn, opt, numerics=True).numerics is not None
    finally:
        set_flags({"FLAGS_numerics_monitor": True})
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "0")
    assert not tnum.monitor_enabled()
    assert tnum.chunk_of_layer(7, 3) == jnum.chunk_of_layer(7, 3) == 2


def test_guarded_train_step_with_the_monitor_makes_no_host_read():
    _, tm = _models()
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(tm, lambda m, x, y, k: m.loss(x, y) * k, opt,
                     scaler=GradScaler(init_loss_scaling=64.0),
                     numerics=True)
    ids = torch.zeros(2, 16, dtype=torch.long)
    with _NoHostRead():
        step(ids, ids, torch.tensor(1.0))
        step(ids, ids, torch.tensor(float("inf")))
        step(ids, ids, torch.tensor(1.0))
    s = step.numerics.summary()
    assert s["steps_seen"] == 3 and s["finite_frac"] == 2 / 3
    assert opt._step_count == 2
    # the skipped step's update rows are 0: the parameters did not move
    upd = [r for r in step.numerics.history()[1]["rows"]]
    assert all(r["update_ratio"] == 0.0 for r in upd)
