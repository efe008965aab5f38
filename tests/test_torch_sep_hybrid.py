"""The sep axis beside mp and pp (BASELINE config 5's tp x pp x sep, at
2 x 2 x 2), in gloo ranks on the CPU (`sep_selftest`'s ``sep_mp``,
``sep_pp`` and ``sep_hybrid`` cases, no jax, one launch a world),
against the JAX package's world of one on the same weights and batch.

The tiny LLaMA is GQA (vocab 64, hidden 32, 2 layers, 4 query heads over
2 KV heads, so mp 2 leaves one KV head a rank), numpy weights from a
seed in the reference's names, carried by `convert` (the rank's
Megatron blocks under mp; the pipe's entries by `sep_selftest.
pipe_name`). The batch is 4 x 16 tokens whose labels are -100 past 12
and 10 tokens of alternate rows, so the sep blocks' token counts differ
(8 and 4, 8 and 2) while the two micro-batches' counts are equal (the
pipe's mean of micro-batch means is then the global mean). Worlds, each
with ``use_ring_attention`` on (the plain ring) and off (the gathered
K/V):

* mp 2 x sep 2: ``fleet.distributed_model(llama)`` (`SegmentParallel`
  over the Megatron blocks) and its ``train_step`` over
  ``model.loss(ids, labels)`` (the vocab-parallel fused CE);
* pp 2 x sep 2 and mp 2 x pp 2 x sep 2 (8 ranks): `LlamaForCausalLMPipe`
  through ``fleet.distributed_model`` (`PipelineParallel`, 2
  micro-batches) and ``fleet.distributed_optimizer``: ``eval_batch``,
  then ``train_batch``.

Reference: `paddle_tpu.models.LlamaForCausalLM`, its criterion over the
logits and 3 `paddle_tpu.jit.TrainStep` s over ``loss(ids, labels)``
with AdamW and an active ``ClipGradByGlobalNorm(0.1)`` (Adam's epsilon
1e-3, so the update follows the clip's scale). Bars, the reference's
own: the forward loss rtol 1e-5; each step's loss |diff| < 5e-4, the
parameters (the ranks' blocks joined over mp and the stages) relative
< 5e-3 (tests/test_training_kernels.py:110-115); the ranks that share
an mp block and a stage (the sep ranks) bit-identical. Also: the
coordinates and groups against the reference's `CommunicateTopology`
(the port's at pp 2 x sep 2 x mp 2 and dp 2 x sep 2 x mp 2 with no
launch; each launched world's groups, and the optimizer's non-finite
flag group: pp x mp, C17).
"""
import functools

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed.fleet import CommunicateTopology as JTopo
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.fleet.topology import CommunicateTopology
from paddle_tpu_torch.distributed.sep_selftest import pipe_name, start
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=32, intermediate_size=48)
STEPS, LR, CLIP, EPS, ACCUMULATE = 3, 1e-2, 0.1, 1e-3, 2
FWD_RTOL, LOSS_BAR, REL_BAR = 1e-5, 5e-4, 5e-3
KEEP = (12, 10, 12, 10)
# case and (pp, mp) of each world; sep 2 in each
WORLDS = {"mp2sep2": ("sep_mp", 1, 2), "pp2sep2": ("sep_pp", 2, 1),
          "mp2pp2sep2": ("sep_hybrid", 2, 2)}
RUNS = ("ring", "gathered")
SEP = 2
NAMES = ("pipe", "data", "sharding", "sep", "model")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jmodel():
    paddle.seed(0)
    return JModel(JConfig(**TINY))


@functools.lru_cache(maxsize=None)
def _named():
    """Numpy weights of the reference's names and layouts."""
    rng = np.random.default_rng(2)
    out = {}
    for name, p in _jmodel().named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        out[name] = 1.0 + 0.1 * a if p.ndim == 1 else 0.1 * a
    return out


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, (4, 16))
    labels = rng.integers(0, 64, (4, 16))
    for i, keep in enumerate(KEEP):
        labels[i, keep:] = -100
    return ids, labels


def _load():
    m = _jmodel()
    for name, p in m.named_parameters():
        p._data = jnp.asarray(_named()[name])
    m.train()
    return m


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's world of one: the criterion's loss over the
    logits, then 3 `TrainStep` s over ``loss(ids, labels)``: losses and
    the final parameters."""
    ids, labels = _batch()
    tids = paddle.to_tensor(ids, dtype="int64")
    tlabels = paddle.to_tensor(labels, dtype="int64")
    fwd = float(JCrit()(_load()(tids), tlabels))
    m = _load()
    opt = popt.AdamW(learning_rate=LR, epsilon=EPS, weight_decay=0.01,
                     parameters=m.parameters(), grad_clip=JClip(CLIP))
    step = JTrainStep(m, lambda mm, i, l: mm.loss(i, l), opt)
    losses = [float(step(tids, tlabels)) for _ in range(STEPS)]
    return {"fwd_loss": fwd, "losses": np.asarray(losses),
            "params": {n: np.asarray(p._data)
                       for n, p in m.named_parameters()}}


@pytest.fixture(scope="module")
def worlds():
    ids, labels = _batch()
    args = {"llama": TINY, "named": _named(), "ids": ids, "labels": labels,
            "steps": STEPS, "lr": LR, "clip": CLIP, "eps": EPS,
            "accumulate": ACCUMULATE}
    jobs = {w: start(case, pp * mp * SEP, dict(args, pp=pp, mp=mp),
                     timeout=60)
            for w, (case, pp, mp) in WORLDS.items()}
    try:
        _reference()
    finally:
        ranks = {w: job.wait(deadline=180) for w, job in jobs.items()}
    return ranks


def _topo(dp=1, pp=1, sep=1, mp=1):
    return dict(dims=(pp, dp, 1, sep, mp))


@pytest.mark.parametrize("layout", [_topo(pp=2, sep=2, mp=2),
                                    _topo(dp=2, sep=2, mp=2)],
                         ids=["pp2sep2mp2", "dp2sep2mp2"])
def test_topology_is_the_reference_s(layout):
    """The port's coordinate arithmetic at the two layouts, no launch:
    every rank's coordinates, every axis's lines and every coordinate's
    ranks."""
    ref, port = JTopo(**layout), CommunicateTopology(**layout)
    assert port.get_hybrid_group_names() == ref.get_hybrid_group_names()
    assert port.world_size() == ref.world_size() == 8
    for r in range(8):
        assert tuple(port.get_coord(r)) == tuple(ref.get_coord(r))
    for axis in NAMES:
        assert port.get_comm_list(axis) == ref.get_comm_list(axis), axis
        for i in range(ref.get_dim(axis)):
            assert port.get_axis_list(axis, i) == ref.get_axis_list(axis, i)


def _fused(topo, r, axes):
    """The ranks that share ``r``'s coordinates off ``axes``."""
    c = topo.get_coord(r)
    return [q for q in range(topo.world_size())
            if all(a == b for n, a, b in zip(NAMES, topo.get_coord(q), c)
                   if n not in axes)]


@pytest.mark.parametrize("world", list(WORLDS))
def test_groups_are_the_reference_s(worlds, world):
    _, pp, mp = WORLDS[world]
    topo = JTopo(**_topo(pp=pp, sep=SEP, mp=mp))
    for r, out in enumerate(worlds[world]):
        c = topo.get_coord(r)
        assert out["coords"] == [c[1], c[0], c[3], c[4]], r
        for key, axis in (("dp", "data"), ("mp", "model"), ("pp", "pipe"),
                          ("sep", "sep")):
            line = next(g for g in topo.get_comm_list(axis) if r in g)
            assert out["groups"][key] == line, (key, r)
        assert out["groups"]["dp_sep"] == _fused(topo, r, ("data", "sep"))
        check = _fused(topo, r, ("pipe", "model"))
        assert out["groups"]["check"] == check
        # the guarded step's non-finite flag: one over pp x mp (C17), the
        # sep ranks' grads being equal after the dp+sep reduction
        for run in RUNS:
            assert out[run]["found_group"] == check, (world, run, r)


def _joined(world, ranks, run):
    """The ranks' states joined into the reference's names (over mp,
    then over the stages, the sep ranks bit-identical first)."""
    _, pp, mp = WORLDS[world]
    by = {}
    for out in ranks:
        _, stage, s, r = out["coords"]
        by.setdefault((stage, r), {})[s] = out[run]["state"]
    for key, states in by.items():        # the sep ranks hold one block
        for k, v in states[0].items():
            for s in range(1, SEP):
                np.testing.assert_array_equal(states[s][k], v,
                                              err_msg=(world, run, key, k))
    from types import SimpleNamespace

    stand_in = SimpleNamespace(nranks=mp, rank=0) if mp > 1 else None
    joined = {}
    for stage in range(pp):
        model = (LlamaForCausalLMPipe(LlamaConfig(**TINY), device="cpu",
                                      num_stages=pp, stage_id=stage,
                                      mp_group=stand_in) if pp > 1 else
                 LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                                  mp_group=stand_in))
        plan = convert.mp_plan(model)
        states = [by[(stage, r)][0] for r in range(mp)]
        for k in states[0]:
            if k not in plan:        # replicated: alike over mp
                for st in states[1:]:
                    np.testing.assert_array_equal(st[k], states[0][k])
        joined.update(convert.mp_state_dict_to_jax(
            [{k: torch.from_numpy(v) for k, v in st.items()}
             for st in states], model, plan=plan))
    return joined


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_forward_loss_is_the_world_of_one_s(worlds, world, run):
    want = _reference()["fwd_loss"]
    for out in worlds[world]:
        np.testing.assert_allclose(out[run]["fwd_loss"], want,
                                   rtol=FWD_RTOL, err_msg=(world, run))


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_training_is_the_world_of_one_s(worlds, world, run):
    want = _reference()
    _, pp, mp = WORLDS[world]
    ranks = worlds[world]
    for out in ranks:
        got = out[run]
        if pp > 1:
            assert got["wrapper"] == "PipelineParallel"
        else:
            assert got["types"] == ["SegmentParallel",
                                    "HybridParallelOptimizer"]
        gap = np.abs(got["losses"] - want["losses"]).max()
        assert gap < LOSS_BAR, (world, run, got["losses"], want["losses"])
    joined = _joined(world, ranks, run)
    names = {(pipe_name(k, TINY["num_layers"]) if pp > 1 else k): k
             for k in want["params"]}
    assert set(joined) == set(names)
    for k, v in joined.items():
        assert _rel(v, want["params"][names[k]]) < REL_BAR, (world, run, k)
    assert want["losses"][-1] < want["losses"][0]


def test_gpt_pipe_refuses_under_sep(worlds):
    """`GPTForCausalLMPipe` at pp 2 x sep 2 raises, naming A9b.5b:
    nothing cuts its input, so its attention would run the sep branch
    over the whole sequence (sep rank 1's loss off the world of one's)."""
    for out in worlds["pp2sep2"]:
        assert "A9b.5b" in out["gpt_pipe"], out["gpt_pipe"]
