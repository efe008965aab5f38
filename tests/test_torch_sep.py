"""The sep axis of the port (sequence blocks: the topology's sep and
dp+sep groups, ``fleet.init(sep_degree)``, `SegmentParallel`, GPT and
LLaMA over the sep group), in gloo ranks on the CPU (`sep_selftest`'s
``sep`` case, no jax, one launch a world), against the JAX package's
world of one on the same weights and batch.

Worlds: sep 2, sep 4 and dp 2 x sep 2. A tiny GPT (vocab 64, hidden 32,
2 layers, 4 heads) with ``use_ring_attention`` on (the plain ring) and
off (the rank's queries over the gathered K/V), and at sep 2 a tiny GQA
LLaMA (4 query heads over 2 KV heads) the same two ways; numpy weights
from a seed in the reference's names, carried by `convert`; a batch of
4 x 16 tokens, each dp rank on its rows, each sep rank on its block of
16 / sep tokens. Bars:

* the reference's ``crit(SegmentParallel(model, hcg)(ids), labels)``
  (tests/test_ring_attention.py:141-146): the loss within rtol 1e-5 of
  the world of one's (the mean over the dp ranks), the embedding's grad
  after ``apply_collective_grads`` within 1e-5;
* 3 steps of ``fleet.distributed_model(model).train_step`` (AdamW with
  ``ClipGradByGlobalNorm(0.1)``; Adam's epsilon 1e-3, so the update
  follows the clip's scale) over ``model.loss(ids, labels, loss_mask)``
  against the reference's `TrainStep` over the same: loss |diff| < 5e-4
  each step, parameters relative < 5e-3 (tests/test_training_kernels.py:
  110-115); the ranks' parameters identical. The loss mask keeps 12 and
  10 tokens of alternate rows, so the sep blocks' counts differ (at sep
  4 the last block holds none) while the dp ranks' rows hold equal
  counts (the dp mean of the ranks' losses is the global mean then, as
  `DataParallel`'s is);
* the coordinates, the sep group and the dp+sep group against the
  reference's `CommunicateTopology`;
* the refusals that name ROADMAP A9b.5b, in this process with a
  stand-in topology: attention dropout, segment ids, a length that does
  not split, a ``scan_layers`` GPT, draft heads, the sharding axis (alone
  and beside mp), ``group_sharded_parallel``, a sharded optimizer, a
  model that is no `PipelineLayer` at pp x sep through
  ``fleet.distributed_model``, and `GPTForCausalLMPipe` under sep (the
  sep axis beside mp and pp: `test_torch_sep_hybrid.py`).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed.fleet import CommunicateTopology as JTopo
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import GPTPretrainingCriterion as JCrit
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch.distributed.fleet import fleet as _fleet
from paddle_tpu_torch.distributed.fleet import topology
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    SegmentParallel, sep_shard)
from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
    HybridParallelOptimizer)
from paddle_tpu_torch.distributed.sep_selftest import start
from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.models.gpt_pipe import GPTForCausalLMPipe
from paddle_tpu_torch.optimizer import AdamW

GPT = dict(vocab_size=64, hidden_size=32, num_layers=2,
           num_attention_heads=4, max_position_embeddings=32,
           hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LLAMA = dict(vocab_size=64, hidden_size=32, num_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=32, intermediate_size=48)
STEPS, LR, CLIP, EPS = 3, 1e-2, 0.1, 1e-3
FWD_RTOL, GRAD_ATOL, LOSS_BAR, REL_BAR = 1e-5, 1e-5, 5e-4, 5e-3
WORLDS = {"sep2": (1, 2), "sep4": (1, 4), "dp2sep2": (2, 2)}
RUNS = ("ring", "gathered")
EMB = {"gpt": "gpt.wte.weight", "llama": "llama.embed_tokens.weight"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _jmodel(family):
    paddle.seed(0)
    return (JGPT(JGPTConfig(**GPT)) if family == "gpt"
            else JLlama(JLlamaConfig(**LLAMA)))


@functools.lru_cache(maxsize=None)
def _named(family):
    """Numpy weights of the reference's names and layouts."""
    rng = np.random.default_rng(2)
    out = {}
    for name, p in _jmodel(family).named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        out[name] = (a * 0.05 if name.endswith("bias") else
                     1.0 + 0.1 * a if p.ndim == 1 else a * 0.1)
    return out


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, (4, 16))
    labels = rng.integers(0, 64, (4, 16))
    mask = np.zeros((4, 16), np.float32)
    for i, keep in enumerate((12, 10, 12, 10)):
        mask[i, :keep] = 1.0
    return ids, labels, mask


def _load(family):
    m = _jmodel(family)
    for name, p in m.named_parameters():
        p._data = jnp.asarray(_named(family)[name])
    m.train()
    return m


@functools.lru_cache(maxsize=None)
def _reference(family):
    """The reference's world of one: the criterion's loss and the
    embedding's grad, then 3 `TrainStep`s over ``loss(ids, labels,
    loss_mask)``: losses and the final parameters."""
    ids, labels, mask = _batch()
    m = _load(family)
    tids = paddle.to_tensor(ids, dtype="int64")
    tlabels = paddle.to_tensor(labels, dtype="int64")
    loss = JCrit()(m(tids), tlabels)
    loss.backward()
    grad = np.asarray(dict(m.named_parameters())[EMB[family]].grad._data)
    m = _load(family)
    opt = popt.AdamW(learning_rate=LR, epsilon=EPS, weight_decay=0.01,
                     parameters=m.parameters(), grad_clip=JClip(CLIP))
    step = JTrainStep(m, lambda mm, i, l, k: mm.loss(i, l, k), opt)
    tmask = paddle.to_tensor(mask)
    losses = [float(step(tids, tlabels, tmask)) for _ in range(STEPS)]
    return {"fwd_loss": float(loss), "emb_grad": grad,
            "losses": np.asarray(losses),
            "params": {n: np.asarray(p._data)
                       for n, p in m.named_parameters()}}


@functools.lru_cache(maxsize=None)
def _spawned(name):
    dp, sep = WORLDS[name]
    ids, labels, mask = _batch()
    families = ("gpt", "llama") if name == "sep2" else ("gpt",)
    job = start("sep", dp * sep, {
        "dp": dp, "families": families, "steps": STEPS, "lr": LR,
        "clip": CLIP, "eps": EPS, "gpt": GPT, "llama": LLAMA,
        "named": {f: _named(f) for f in families}, "ids": ids,
        "labels": labels, "mask": mask}, timeout=60)
    try:
        for f in families:
            _reference(f)
    finally:
        ranks = job.wait(deadline=150)
    return ranks


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    return request.param, _spawned(request.param)


def test_coordinates_and_groups_are_the_reference_s(world):
    name, ranks = world
    dp, sep = WORLDS[name]
    topo = JTopo(dims=(1, dp, 1, sep, 1))
    names = topo.get_hybrid_group_names()
    for r, out in enumerate(ranks):
        c = topo.get_coord(r)
        assert out["coords"] == [c[names.index("data")],
                                 c[names.index("sep")]]
        assert out["degrees"] == [dp, sep]
        for axis, key in (("sep", "sep"), ("data", "dp")):
            line = next(g for g in topo.get_comm_list(axis) if r in g)
            assert out["groups"][key] == line, (axis, r)
        fused = [q for q in range(dp * sep)
                 if all(a == b for i, (a, b) in enumerate(
                     zip(topo.get_coord(q), c))
                        if names[i] not in ("data", "sep"))]
        assert out["groups"]["dp_sep"] == fused
        assert all(out[f"gpt_{run}"]["wrapper"] == "SegmentParallel"
                   for run in RUNS)


def _hold_forward(ranks, family, run, dp):
    want = _reference(family)
    key = f"{family}_{run}"
    # each dp rank's loss is its rows' mean; their mean is the global one
    by_dp = {}
    for out in ranks:
        by_dp.setdefault(out["coords"][0], []).append(out[key]["fwd_loss"])
    for losses in by_dp.values():          # every sep rank holds it
        assert len(set(losses)) == 1, losses
    got = np.mean([v[0] for v in by_dp.values()])
    np.testing.assert_allclose(got, want["fwd_loss"], rtol=FWD_RTOL)
    for out in ranks:
        np.testing.assert_allclose(out[key]["emb_grad"], want["emb_grad"],
                                   rtol=0, atol=GRAD_ATOL)


def _hold_training(ranks, family, run):
    want = _reference(family)
    key = f"{family}_{run}"
    from paddle_tpu_torch import convert

    for out in ranks:
        got = out[key]
        assert np.abs(got["losses"] - want["losses"]).max() < LOSS_BAR, (
            got["losses"], want["losses"])
        named = convert.state_dict_to_jax(
            {k: torch.from_numpy(v) for k, v in got["state"].items()})
        for name, w in want["params"].items():
            assert _rel(np.asarray(named[name]), w) < REL_BAR, name
        for k, v in got["state"].items():
            np.testing.assert_array_equal(v, ranks[0][key]["state"][k])


@pytest.mark.parametrize("run", RUNS)
def test_gpt_forward_matches_the_world_of_one(world, run):
    name, ranks = world
    _hold_forward(ranks, "gpt", run, WORLDS[name][0])


@pytest.mark.parametrize("run", RUNS)
def test_gpt_training_matches_the_world_of_one(world, run):
    _, ranks = world
    _hold_training(ranks, "gpt", run)


@pytest.mark.parametrize("run", RUNS)
def test_llama_gqa_matches_the_world_of_one(run):
    ranks = _spawned("sep2")
    assert all(out[f"llama_{run}"]["wrapper"] == "SegmentParallel"
               for out in ranks)
    _hold_forward(ranks, "llama", run, 1)
    _hold_training(ranks, "llama", run)


# ---------------------------------------------------------------------------
# refusals, with a stand-in topology (no processes)
# ---------------------------------------------------------------------------

class _Hcg:
    """What the models and `SegmentParallel` read of the topology."""

    def __init__(self, sep=2, mp=1, pp=1, sharding=1, dp=1):
        self.d = dict(sep=sep, mp=mp, pp=pp, sharding=sharding, dp=dp)

    def get_sep_parallel_world_size(self):
        return self.d["sep"]

    def get_model_parallel_world_size(self):
        return self.d["mp"]

    def get_pipe_parallel_world_size(self):
        return self.d["pp"]

    def get_sharding_parallel_world_size(self):
        return self.d["sharding"]

    def get_data_parallel_world_size(self):
        return self.d["dp"]

    def get_sep_parallel_group(self):
        return SimpleNamespace(nranks=self.d["sep"], rank=0)

    def get_model_parallel_group(self):
        return SimpleNamespace(nranks=self.d["mp"], rank=0)


@pytest.fixture
def stand_in():
    hcg = _Hcg()
    topology.set_hybrid_communicate_group(hcg)
    held = _fleet._hcg
    _fleet._hcg = hcg
    try:
        yield hcg
    finally:
        topology.set_hybrid_communicate_group(None)
        _fleet._hcg = held


def _ids(s=16):
    return torch.zeros(2, s, dtype=torch.long)


@pytest.mark.parametrize("what", [
    "attention dropout", "segment ids", "length", "scan_layers model",
    "scan_layers wrapper", "draft heads", "sharding beside mp", "pp model",
    "sharding", "group_sharded_parallel", "sharded optimizer", "gpt pipe"])
def test_what_is_left_refuses_naming_a9b5b(stand_in, what):
    err = ValueError if what == "length" else NotImplementedError
    with pytest.raises(err, match=r"A9b\.5b"):
        if what == "attention dropout":
            m = GPTForCausalLM(GPTConfig(**{**GPT,
                                            "attention_dropout_prob": 0.1}),
                               device="cpu")
            m.train()
            m(_ids(8))
        elif what == "segment ids":
            m = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
            m(_ids(8), segment_ids=_ids(8))
        elif what == "length":
            sep_shard(_ids(15))
        elif what == "scan_layers model":
            m = GPTForCausalLM(GPTConfig(**GPT, scan_layers=True),
                               device="cpu")
            m(_ids(8))
        elif what == "scan_layers wrapper":
            SegmentParallel(GPTForCausalLM(GPTConfig(**GPT, scan_layers=True),
                                           device="cpu"), stand_in)
        elif what == "draft heads":
            m = GPTForCausalLM(GPTConfig(**GPT, num_draft_heads=1),
                               device="cpu")
            m.loss(_ids(8), _ids(8))
        elif what in ("sharding", "sharding beside mp"):
            stand_in.d["sharding"] = 2
            stand_in.d["mp"] = 2 if what != "sharding" else 1
            SegmentParallel(GPTForCausalLM(GPTConfig(**GPT), device="cpu"),
                            stand_in)
        elif what == "pp model":
            # a model that is no PipelineLayer at pp x sep: the fleet
            # refuses it (a PipelineLayer goes to PipelineParallel)
            stand_in.d["pp"] = 2
            _fleet.distributed_model(
                LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu"))
        elif what == "group_sharded_parallel":
            m = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
            group_sharded_parallel(m, AdamW(parameters=m.parameters()),
                                   "os_g")
        elif what == "sharded optimizer":
            m = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
            HybridParallelOptimizer(AdamW(parameters=m.parameters()),
                                    stand_in,
                                    SimpleNamespace(sharding=True))
        else:
            GPTForCausalLMPipe(GPTConfig(**GPT), num_stages=2, num_micro=2,
                               device="cpu")


def test_ring_config_runs_dense_at_a_world_of_one():
    """``use_ring_attention`` without a sep group is the dense model, as
    in the reference (no sep mesh: no ring)."""
    torch.manual_seed(0)
    ids = torch.randint(0, 64, (2, 16))
    for cls, cfg_cls, cfg in ((GPTForCausalLM, GPTConfig, GPT),
                              (LlamaForCausalLM, LlamaConfig, LLAMA)):
        plain = cls(cfg_cls(**cfg), device="cpu", seed=5)
        ring = cls(cfg_cls(**cfg, use_ring_attention=True), device="cpu",
                   seed=5)
        torch.testing.assert_close(ring(ids), plain(ids), rtol=0, atol=0)
