"""The port's Megatron layers (`distributed.fleet.layers.mpu`), their
fleet wrappers and the sequence-parallel operators, in 2 and 4 gloo
ranks on the CPU (`mp_selftest`, no jax), against the JAX package's
layers on a CPU mesh with an mp axis of the same degree.

Global weights and inputs are drawn with numpy from a seed in the
reference's layouts; rank r takes its blocks through
`convert.mp_state_dict_from_jax`. Each layer's loss is ``sum(out * R)``
for a fixed R. Bars: outputs 1e-5, rank r's gradient (of a block) the
reference's block r 1e-5, input grads 1e-5, fp32. Also:

* ``fleet.init`` at mp = the world: the topology's mp getters; at dp 2 x
  mp 2 the groups and `fused_allreduce_gradients` over dp alone;
* the RNG tracker: masks repeat for a seed, differ across mp ranks
  under the model-parallel state and agree under the default one;
* a small model of mpu layers (embedding, column, row, LayerNorm,
  vocab-parallel head and `ParallelCrossEntropy`) through
  ``fleet.distributed_model`` (`TensorParallel`) and
  ``fleet.distributed_optimizer`` with AdamW and an active
  ``ClipGradByGlobalNorm``, 3 `jit.TrainStep` s against the reference's
  eager loop: losses 5e-4, parameters 5e-3 relative (ROADMAP's training
  bars), the clip's squared norm 1e-5 relative; joining the ranks'
  blocks (`convert.mp_state_dict_to_jax`) gives the reference's layout;
* the same model at sharding 2 x mp 2 (`DygraphShardingOptimizer` under
  the `HybridParallelOptimizer`, each sharding rank on half the rows)
  against the same reference: the clip's norm spans both mp ranks'
  blocks, so the replicated parameters stay equal across mp ranks;
* the broadcasts: replicated parameters from group rank 0, blocks kept;
* the sequence-parallel operators and layers at 2 ranks.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.fleet.layers import mpu as jmpu
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.mp_selftest import _tp_net, start

ATOL = 1e-5
V, H, F, B, S = 48, 16, 32, 2, 5
TP = dict(vocab=64, hidden=16, ffn=32)
STEPS, LR, CLIP = 3, 1e-2, 0.05


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    labels = rng.integers(0, V, (B, S))
    labels[0, 1] = -100
    tp_ids = rng.integers(0, TP["vocab"], (4, 6))
    tp_labels = rng.integers(0, TP["vocab"], (4, 6))
    return {
        "emb_w": f(V, H), "ids": rng.integers(0, V, (B, S)),
        "r_emb": f(B, S, H), "x": f(B, S, H), "col_w": f(H, F) * 0.3,
        "col_b": f(F), "r_col": f(B, S, F), "row_w": f(F, H) * 0.3,
        "row_b": f(H), "r_row": f(B, S, H), "x2": f(B, S, F),
        "logits": f(B, S, V), "labels": labels, "r_ce": f(B, S),
        "tp": {"named": _tp_named(rng), "dims": TP, "ids": tp_ids,
               "labels": tp_labels, "lr": LR, "clip": CLIP,
               "steps": STEPS}}


def _tp_named(rng):
    v, h, f = TP["vocab"], TP["hidden"], TP["ffn"]
    g = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)  # noqa
    return {"emb.weight": g(v, h), "fc1.weight": g(h, f),
            "fc1.bias": g(f), "fc2.weight": g(f, h), "fc2.bias": g(h),
            "ln.weight": 1.0 + g(h), "ln.bias": g(h),
            "head.weight": g(h, v), "head.bias": g(v)}


def _tensor(a, grad=False):
    t = paddle.to_tensor(a)
    t.stop_gradient = not grad
    return t


def _set(layer, **arrays):
    for k, a in arrays.items():
        getattr(layer, k)._data = jnp.asarray(a)
    return layer


def _np(t):
    return np.asarray(t._data)


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        v, h, f = TP["vocab"], TP["hidden"], TP["ffn"]
        self.emb = jmpu.VocabParallelEmbedding(v, h)
        self.fc1 = jmpu.ColumnParallelLinear(h, f, gather_output=False)
        self.fc2 = jmpu.RowParallelLinear(f, h, input_is_parallel=True)
        self.ln = jnn.LayerNorm(h)
        self.head = jmpu.ColumnParallelLinear(h, v, gather_output=False)
        self.ce = jmpu.ParallelCrossEntropy()

    def forward(self, ids):
        x = self.emb(ids)
        x = x + self.fc2(JF.gelu(self.fc1(x)))
        return self.head(self.ln(x))

    def loss(self, ids, labels):
        return self.ce(self(ids), labels).mean()


def _reference(n, a):
    jenv.reset()
    jenv.set_mesh(jenv.build_mesh({"mp": n}))
    out = {}
    try:
        emb = _set(jmpu.VocabParallelEmbedding(V, H), weight=a["emb_w"])
        y = emb(paddle.to_tensor(a["ids"], dtype="int64"))
        (y * _tensor(a["r_emb"])).sum().backward()
        out["emb"] = (_np(y), _np(emb.weight.grad))
        x = _tensor(a["x"], True)
        col = _set(jmpu.ColumnParallelLinear(H, F, gather_output=True),
                   weight=a["col_w"], bias=a["col_b"])
        y = col(x)
        (y * _tensor(a["r_col"])).sum().backward()
        out["col"] = (_np(y), [_np(col.weight.grad), _np(col.bias.grad),
                               _np(x.grad)])
        x = _tensor(a["x"], True)
        col = _set(jmpu.ColumnParallelLinear(H, F, gather_output=False),
                   weight=a["col_w"], bias=a["col_b"])
        row = _set(jmpu.RowParallelLinear(F, H, input_is_parallel=True),
                   weight=a["row_w"], bias=a["row_b"])
        mid = col(x)
        y = row(JF.gelu(mid))
        (y * _tensor(a["r_row"])).sum().backward()
        out["pair"] = (_np(mid), _np(y), [
            _np(col.weight.grad), _np(col.bias.grad), _np(row.weight.grad),
            _np(row.bias.grad), _np(x.grad)])
        x2 = _tensor(a["x2"], True)
        row = _set(jmpu.RowParallelLinear(F, H, input_is_parallel=False),
                   weight=a["row_w"], bias=a["row_b"])
        y = row(x2)
        (y * _tensor(a["r_row"])).sum().backward()
        out["row"] = (_np(y), [_np(row.weight.grad), _np(row.bias.grad),
                               _np(x2.grad)])
        logits = _tensor(a["logits"], True)
        loss = jmpu.ParallelCrossEntropy()(
            logits, paddle.to_tensor(a["labels"], dtype="int64"))
        (loss * _tensor(a["r_ce"])).sum().backward()
        out["ce"] = (_np(loss), _np(logits.grad))
        out["tp"] = _reference_tp(a["tp"])
    finally:
        jenv.reset()
    return out


def _reference_tp(t):
    net = _JNet()
    for name, p in net.named_parameters():
        p._data = jnp.asarray(t["named"][name])
    opt = popt.AdamW(learning_rate=t["lr"], parameters=net.parameters(),
                     grad_clip=jnn.ClipGradByGlobalNorm(t["clip"]))
    ids = paddle.to_tensor(t["ids"], dtype="int64")
    labels = paddle.to_tensor(t["labels"], dtype="int64")
    loss = net.loss(ids, labels)
    loss.backward()
    sq = sum(float((_np(p.grad).astype(np.float64) ** 2).sum())
             for p in net.parameters())
    opt.clear_grad()
    losses = []
    for _ in range(t["steps"]):
        loss = net.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return {"losses": np.asarray(losses), "sq": sq,
            "params": {k: _np(p) for k, p in net.named_parameters()}}


def _block(a, r, n, axis):
    w = a.shape[axis] // n
    return np.take(a, np.arange(r * w, (r + 1) * w), axis=axis)


@pytest.fixture(scope="module", params=[2, 4], ids=["mp2", "mp4"])
def world(request):
    n = request.param
    a = _arrays()
    jobs = [start("mp_layers", n, a, timeout=60)]
    if n == 4:
        jobs.append(start("mp_dp", n, {}, timeout=60))
    try:
        ref = _reference(n, a)
    finally:
        ranks = [job.wait(deadline=150) for job in jobs]
    return n, ranks, ref, a


def test_topology_at_mp_the_world(world):
    n, (ranks, *rest), _, _ = world
    for r, out in enumerate(ranks):
        assert out["hcg"] == [n, r, 1, n, 0]
    if rest:            # dp 2 x mp 2
        for r, out in enumerate(rest[0]):
            assert out["groups"] == [[r % 2, r % 2 + 2],
                                     [2 * (r // 2), 2 * (r // 2) + 1]]
            assert out["ranks"] == [r // 2, r % 2]
            # averaged over the dp group alone
            np.testing.assert_array_equal(out["grad"],
                                          np.full(5, r % 2 + 1.0))


def test_vocab_parallel_embedding(world):
    n, (ranks, *_), ref, _ = world
    y, g = ref["emb"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["emb_out"], y, atol=ATOL)
        np.testing.assert_allclose(out["emb_grad"], _block(g, r, n, 0),
                                   atol=ATOL)


def test_column_parallel_gathered(world):
    n, (ranks, *_), ref, _ = world
    y, (gw, gb, gx) = ref["col"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["col_out"], y, atol=ATOL)
        w, b, x = out["col_grads"]
        np.testing.assert_allclose(w, _block(gw, r, n, 1), atol=ATOL)
        np.testing.assert_allclose(b, _block(gb, r, n, 0), atol=ATOL)
        np.testing.assert_allclose(x, gx, atol=ATOL)


def test_column_then_row_parallel(world):
    n, (ranks, *_), ref, _ = world
    mid, y, (cw, cb, rw, rb, gx) = ref["pair"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["pair_mid"], _block(mid, r, n, 2),
                                   atol=ATOL)
        np.testing.assert_allclose(out["pair_out"], y, atol=ATOL)
        w1, b1, w2, b2, x = out["pair_grads"]
        np.testing.assert_allclose(w1, _block(cw, r, n, 1), atol=ATOL)
        np.testing.assert_allclose(b1, _block(cb, r, n, 0), atol=ATOL)
        np.testing.assert_allclose(w2, _block(rw, r, n, 0), atol=ATOL)
        np.testing.assert_allclose(b2, rb, atol=ATOL)
        np.testing.assert_allclose(x, gx, atol=ATOL)


def test_row_parallel_on_a_whole_input(world):
    n, (ranks, *_), ref, _ = world
    y, (gw, gb, gx) = ref["row"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["row_out"], y, atol=ATOL)
        w, b, x = out["row_grads"]
        np.testing.assert_allclose(w, _block(gw, r, n, 0), atol=ATOL)
        np.testing.assert_allclose(b, gb, atol=ATOL)
        np.testing.assert_allclose(x, gx, atol=ATOL)


def test_parallel_cross_entropy(world):
    n, (ranks, *_), ref, _ = world
    loss, g = ref["ce"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["ce_loss"], loss, atol=ATOL)
        np.testing.assert_allclose(out["ce_grad"], _block(g, r, n, 2),
                                   atol=ATOL)


def test_rng_tracker_streams(world):
    n, (ranks, *_), _, _ = world
    for out in ranks:
        run0, run1 = out["rng_runs"]
        np.testing.assert_array_equal(run0, run1)   # a seed repeats
        assert not np.array_equal(run0[0], run0[1])  # the stream goes on
    masks = [out["rng_runs"][0] for out in ranks]
    for m in masks[1:]:
        assert not np.array_equal(m[0], masks[0][0])   # per mp rank
        np.testing.assert_array_equal(m[2], masks[0][2])   # default: alike


def test_tensor_parallel_training_with_the_clip(world):
    n, (ranks, *_), ref, _ = world
    want = ref["tp"]
    net = _tp_net(1, want["params"], 0, "cpu", **TP)
    joined = convert.mp_state_dict_to_jax(
        [{k: torch.from_numpy(v) for k, v in out["tp_state"].items()}
         for out in ranks], net)
    for out in ranks:
        assert out["tp_wrapper"] == "TensorParallel"
        assert out["tp_opt"] == "HybridParallelOptimizer"
        assert abs(out["tp_grad_norm_sq"] - want["sq"]) / want["sq"] < 1e-5
        assert np.abs(out["tp_losses"] - want["losses"]).max() < 5e-4
    for name, w in want["params"].items():
        rel = np.abs(joined[name] - w).max() / np.abs(w).max()
        assert rel < 5e-3, (name, rel)


@pytest.fixture(scope="module")
def sharding_world():
    t = _arrays()["tp"]
    job = start("mp_sharding", 4, {"tp": t}, timeout=60)
    try:
        jenv.reset()
        jenv.set_mesh(jenv.build_mesh({"mp": 2}))
        ref = _reference_tp(t)
    finally:
        jenv.reset()
        ranks = job.wait(deadline=150)
    return ranks, ref


def test_sharding_and_mp_clip_by_the_global_norm(sharding_world):
    ranks, want = sharding_world
    net = _tp_net(1, want["params"], 0, "cpu", **TP)
    states = {}
    for out in ranks:
        assert (out["tp_wrapper"], out["tp_opt"], out["tp_inner"]) == (
            "TensorParallel", "HybridParallelOptimizer",
            "DygraphShardingOptimizer")
        assert abs(out["tp_grad_norm_sq"] - want["sq"]) / want["sq"] < 1e-5
        assert np.abs(out["tp_losses"] - want["losses"]).max() < 5e-4
        states[tuple(out["tp_coords"])] = out["tp_state"]
    assert sorted(states) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for s in (0, 1):
        pair = [states[(s, m)] for m in (0, 1)]
        for name in ("ln.weight", "ln.bias", "fc2.bias"):   # replicated
            np.testing.assert_array_equal(pair[0][name], pair[1][name])
        joined = convert.mp_state_dict_to_jax(
            [{k: torch.from_numpy(v) for k, v in st.items()} for st in pair],
            net)
        for name, w in want["params"].items():
            if s == 1:      # the sharding ranks gather the same update
                np.testing.assert_array_equal(joined[name], first[name])
            rel = np.abs(joined[name] - w).max() / np.abs(w).max()
            assert rel < 5e-3, (s, name, rel)
        first = joined


def test_blocks_round_trip_bit_for_bit(world):
    """The reference's global arrays -> every rank's blocks -> back, the
    same bits (`convert`'s mp maps over the mpu layers)."""
    n, _, _, a = world
    named = a["tp"]["named"]
    full = _tp_net(1, named, 0, "cpu", **TP)
    plan = convert.mp_plan(full)
    port = convert.state_dict_from_jax(named, model=full)
    blocks = [{k: convert.mp_block(t, plan.get(k), r, n)
               for k, t in port.items()} for r in range(n)]
    back = convert.mp_state_dict_to_jax(blocks, full)
    for k, v in named.items():
        np.testing.assert_array_equal(back[k], v)
    assert blocks[1]["fc1.weight"].shape[0] == TP["ffn"] // n
    assert blocks[1]["fc2.weight"].shape[1] == TP["ffn"] // n


def test_broadcasts_over_the_mp_group(world):
    n, (ranks, *_), _, _ = world
    for out in ranks:
        np.testing.assert_array_equal(out["bcast_bias"], np.ones(4))
        assert out["bcast_block_kept"]
        np.testing.assert_array_equal(out["bcast_input"], np.zeros(3))


# ---------------------------------------------------------------------------
# sequence parallelism, 2 ranks
# ---------------------------------------------------------------------------

SP_S, SP_B = 6, 2


def _sp_arrays(seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(SP_S, SP_B, H), "r_full": f(SP_S, SP_B, H),
            "col_w": f(H, F) * 0.3, "col_b": f(F), "row_w": f(F, H) * 0.3,
            "row_b": f(H), "r_out": f(SP_S, SP_B, H)}


def _sp_reference(a):
    """The reference's sequence-parallel layers on a 2-device mp mesh
    (global arrays in and out)."""
    from paddle_tpu.distributed.fleet.utils import sequence_parallel_utils \
        as jsp

    jenv.reset()
    jenv.set_mesh(jenv.build_mesh({"mp": 2}))
    try:
        x = _tensor(a["x"], True)
        col = _set(jsp.ColumnSequenceParallelLinear(H, F),
                   weight=a["col_w"], bias=a["col_b"])
        row = _set(jsp.RowSequenceParallelLinear(F, H),
                   weight=a["row_w"], bias=a["row_b"])
        mid = col(x)
        y = row(mid)
        (y * _tensor(a["r_out"])).sum().backward()
        return _np(mid), _np(y), [_np(col.weight.grad), _np(col.bias.grad),
                                  _np(row.weight.grad), _np(row.bias.grad),
                                  _np(x.grad)]
    finally:
        jenv.reset()


@pytest.fixture(scope="module")
def sp_world():
    a = _sp_arrays()
    job = start("sequence_parallel", 2, a, timeout=60)
    try:
        ref = _sp_reference(a)
    finally:
        ranks = job.wait(deadline=120)
    return ranks, ref, a


def test_sequence_parallel_operators(sp_world):
    ranks, _, a = sp_world
    x, rf = a["x"], a["r_full"]
    for r, out in enumerate(ranks):
        # gather / all-gather: the whole sequence; grads the rank's block
        for k in ("gather", "all_gather"):
            np.testing.assert_array_equal(out[k], x)
        np.testing.assert_allclose(out["gather_grad"], _block(rf, r, 2, 0),
                                   atol=ATOL)
        # all-gather's backward reduce-scatters: both ranks' R summed
        np.testing.assert_allclose(out["all_gather_grad"],
                                   2 * _block(rf, r, 2, 0), atol=ATOL)
        # scatter's backward gathers the ranks' block grads
        np.testing.assert_array_equal(out["scatter"], _block(x, r, 2, 0))
        np.testing.assert_array_equal(out["scatter_grad"], rf)
        # reduce-scatter of x * (rank + 1) over 2 ranks: 3 x, the block
        np.testing.assert_allclose(out["reduce_scatter"],
                                   3 * _block(x, r, 2, 0), atol=ATOL)
        np.testing.assert_allclose(
            out["reduce_scatter_grad"],
            np.concatenate([_block(rf, k, 2, 0) for k in range(2)]),
            atol=ATOL)


def test_sequence_parallel_linears(sp_world):
    ranks, (mid, y, (cw, cb, rw, rb, gx)), _ = sp_world
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["sp_mid"], _block(mid, r, 2, 2),
                                   atol=ATOL)
        np.testing.assert_allclose(out["sp_out"], _block(y, r, 2, 0),
                                   atol=ATOL)
        w1, b1, w2, b2, x = out["sp_grads"]
        np.testing.assert_allclose(w1, _block(cw, r, 2, 1), atol=ATOL)
        np.testing.assert_allclose(b1, _block(cb, r, 2, 0), atol=ATOL)
        np.testing.assert_allclose(w2, _block(rw, r, 2, 0), atol=ATOL)
        # the row bias: a sequence-parallel parameter, its grad summed by
        # the hook over the ranks' sequence blocks
        np.testing.assert_allclose(b2, rb, atol=ATOL)
        np.testing.assert_allclose(x, _block(gx, r, 2, 0), atol=ATOL)
        assert out["sp_hooks"] == 1


@pytest.fixture(scope="module")
def nonfinite_world():
    """The small model at mp 2 through `TensorParallel`, a
    `HybridParallelOptimizer` and a `jit.TrainStep` with a `GradScaler`,
    an inf in rank 1's block's grad at the first step; and the
    reference's eager scaler over the same inf."""
    t = _arrays()["tp"]
    job = start("mp_nonfinite", 2, {"tp": t}, timeout=60)
    try:
        jenv.reset()
        jenv.set_mesh(jenv.build_mesh({"mp": 2}))
        net = _JNet()
        for name, p in net.named_parameters():
            p._data = jnp.asarray(t["named"][name])
        opt = popt.AdamW(learning_rate=t["lr"], parameters=net.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(t["clip"]))
        scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0)
        loss = net.loss(paddle.to_tensor(t["ids"], dtype="int64"),
                        paddle.to_tensor(t["labels"], dtype="int64"))
        scaler.scale(loss).backward()
        w = net.fc1.weight
        w.grad._data = w.grad._data.at[0, 0].set(jnp.inf)
        scaler.step(opt)
        scaler.update()
        ref = ({k: _np(p) for k, p in net.named_parameters()},
               float(scaler.get_loss_scaling()))
    finally:
        jenv.reset()
        ranks = job.wait(deadline=150)
    return ranks, ref, t


def test_nonfinite_flag_is_one_flag_over_the_mp_group(nonfinite_world):
    """An inf in one mp rank's grads: every rank skips the step (its
    blocks and replicated parameters unchanged and alike over the ranks)
    and halves its scale, as the reference's global flag does; the next,
    clean step moves every rank."""
    ranks, (want_params, want_scale), t = nonfinite_world
    for k, v in want_params.items():              # the reference skips
        np.testing.assert_array_equal(v, t["named"][k])
    assert want_scale == 512.0
    net = _tp_net(1, t["named"], 0, "cpu", **TP)
    joined = convert.mp_state_dict_to_jax(
        [{k: torch.from_numpy(v) for k, v in out["skipped"].items()}
         for out in ranks], net)
    for k, want in want_params.items():
        np.testing.assert_array_equal(joined[k], want)
    for out in ranks:
        assert out["scale"] == want_scale
        for k, v in out["skipped"].items():
            np.testing.assert_array_equal(v, out["before"][k])
        assert any(np.abs(out["stepped"][k] - out["before"][k]).max() > 0
                   for k in out["before"])
        assert out["scale_after"] == want_scale
    for name in ("ln.weight", "ln.bias", "fc2.bias"):       # replicated
        np.testing.assert_array_equal(ranks[0]["stepped"][name],
                                      ranks[1]["stepped"][name])
