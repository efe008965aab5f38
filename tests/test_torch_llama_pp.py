"""LLaMA through the pipeline: `models.LlamaForCausalLMPipe` (the
embedding, the decoder layers, the final norm and the head as
`LayerDesc` s, ``LlamaPretrainingCriterion`` as the loss) through
``fleet.distributed_model`` (`PipelineParallel`) at pp 2 and pp 2 x mp 2
in gloo ranks on the CPU (`llama_selftest`, no jax), against the JAX
package's `PipelineParallel(PipelineLayer(...), hcg=None)` over the same
pieces built from `LayerDesc` s (its single controller runs the stages
in turn).

The tiny LLaMA is `test_torch_llama_mp`'s (the reference test's
``_tiny_llama``: 2 layers, split one a stage by
``seg_method="layer:LlamaDecoderLayer"``). Weights are drawn with numpy
in the reference's `PipelineLayer` names (``_layers_list.{k}...``);
a rank takes its stage's entries, under mp its blocks of them
(`convert.pipeline_state_dict_from_jax`). 3 ``train_batch`` steps of
AdamW with an active ``ClipGradByGlobalNorm`` at ``accumulate_steps`` 2.
Bars: loss |diff| < 5e-4 each step, the ranks' parameters joined (over
mp by `convert.mp_state_dict_to_jax`, then over the stages) within 5e-3
relative; the mp ranks' replicated parameters bit-equal.

A LLaMA that is no `PipelineLayer` trains whole on every pp rank
(`HybridParallel`): at dp 1 x pp 2 and dp 1 x pp 2 x mp 2 its
``fleet.distributed_model(llama).train_step`` with the same active clip
is held to the reference's `TrainStep` of the world of one at the same
bars (the clip's norm counts each parameter once: the pp ranks are
replicas, not stages).
"""
from types import SimpleNamespace

import warnings

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed.fleet.meta_parallel import (
    LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer)
from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel import (
    PipelineParallel as JPipelineParallel)
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu.models.llama import LlamaDecoderLayer as JDecoderLayer
from paddle_tpu.models.llama import LlamaRMSNorm as JRMSNorm
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed.llama_selftest import start
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models import LlamaForCausalLM
from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=32, intermediate_size=48)
STEPS, LR, CLIP, EPS, ACCUMULATE = 3, 1e-2, 0.1, 1e-3, 2
LOSS_BAR, REL_BAR = 5e-4, 5e-3
# (pp, mp) of each world
WORLDS = {"pp2": (2, 1), "pp2mp2": (2, 2)}
HYBRID = {"hybrid_pp2": (2, 1), "hybrid_pp2mp2": (2, 2)}
SEG = "layer:LlamaDecoderLayer"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _stand_in(n, r):
    """What a model reads of a model-parallel group to place its blocks
    (its degree and rank); None below two ranks."""
    return SimpleNamespace(nranks=n, rank=r) if n > 1 else None


class JEmbedPipe(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.embed_tokens = jnn.Embedding(cfg.vocab_size, cfg.hidden_size)

    def forward(self, ids):
        return self.embed_tokens(ids)


class JHeadPipe(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.lm_head = jnn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False)

    def forward(self, h):
        return self.lm_head(h)


def _reference_pipe():
    cfg = JConfig(**TINY)
    descs = ([JLayerDesc(JEmbedPipe, cfg)]
             + [JLayerDesc(JDecoderLayer, cfg)
                for _ in range(cfg.num_layers)]
             + [JLayerDesc(JRMSNorm, cfg.hidden_size, cfg.rms_norm_eps),
                JLayerDesc(JHeadPipe, cfg)])
    paddle.seed(0)
    return JPipelineLayer(descs, num_stages=2, loss_fn=JCrit(),
                          seg_method=SEG)


def _args():
    pl = _reference_pipe()
    rng = np.random.default_rng(2)
    named = {}
    for name, p in pl.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        named[name] = 1.0 + 0.1 * a if p.ndim == 1 else 0.1 * a
    ids = np.random.default_rng(1).integers(0, 64, (4, 16))
    labels = np.random.default_rng(3).integers(0, 64, (4, 16))
    return {"config": TINY, "named": named, "ids": ids, "labels": labels,
            "steps": STEPS, "lr": LR, "clip": CLIP, "eps": EPS,
            "accumulate": ACCUMULATE}


def _reference(a):
    pl = _reference_pipe()
    for name, p in pl.named_parameters():
        p._data = jnp.asarray(a["named"][name])
    pl.train()

    class Strategy:
        pipeline_configs = {"accumulate_steps": ACCUMULATE}

    model = JPipelineParallel(pl, None, Strategy())
    opt = popt.AdamW(learning_rate=LR, epsilon=EPS, weight_decay=0.01,
                     parameters=pl.parameters(), grad_clip=JClip(CLIP))
    data = (paddle.to_tensor(a["ids"], dtype="int64"),
            paddle.to_tensor(a["labels"], dtype="int64"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        losses = [float(model.train_batch(data, opt)) for _ in range(STEPS)]
    return {"losses": np.asarray(losses), "segments": pl.segment_parts,
            "params": {n: np.asarray(p._data)
                       for n, p in pl.named_parameters()}}


def _hybrid_args(a):
    """The untied `LlamaForCausalLM`'s weights, in the reference's names,
    and the pipe's batch and optimizer."""
    paddle.seed(0)
    jm = JModel(JConfig(**TINY))
    rng = np.random.default_rng(4)
    named = {}
    for name, p in jm.named_parameters():
        w = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        named[name] = 1.0 + 0.1 * w if p.ndim == 1 else 0.1 * w
    return dict(a, named=named)


def _hybrid_reference(a):
    """The reference's `TrainStep` over the world of one."""
    paddle.seed(0)
    jm = JModel(JConfig(**TINY))
    for name, p in jm.named_parameters():
        p._data = jnp.asarray(a["named"][name])
    jm.train()
    crit = JCrit()
    opt = popt.AdamW(learning_rate=LR, epsilon=EPS, weight_decay=0.01,
                     parameters=jm.parameters(), grad_clip=JClip(CLIP))
    step = JTrainStep(jm, lambda m, i, l: crit(m(i), l), opt)
    ids, labels = (paddle.to_tensor(a[k], dtype="int64")
                   for k in ("ids", "labels"))
    losses = [float(step(ids, labels)) for _ in range(STEPS)]
    return {"losses": np.asarray(losses),
            "params": {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()}}


@pytest.fixture(scope="module")
def worlds():
    a = _args()
    h = _hybrid_args(a)
    jobs = {w: start("llama_pp", pp * mp, dict(a, pp=pp, mp=mp), timeout=60)
            for w, (pp, mp) in WORLDS.items()}
    jobs.update({w: start("llama_hybrid", pp * mp, dict(h, pp=pp, mp=mp),
                          timeout=60) for w, (pp, mp) in HYBRID.items()})
    try:
        ref = _reference(a)
        ref["hybrid"] = _hybrid_reference(h)
    finally:
        ranks = {w: job.wait(deadline=120) for w, job in jobs.items()}
    return ranks, ref, a


def test_the_pipe_is_the_reference_s_layer_desc_list():
    """A rank's stage holds the reference's entries under its names, at
    its bounds."""
    ref = _reference_pipe()
    names = {n for n, _ in ref.named_parameters()}
    held = set()
    for stage in range(2):
        pl = LlamaForCausalLMPipe(LlamaConfig(**TINY), device="cpu",
                                  num_stages=2, stage_id=stage)
        assert pl.segment_parts == ref.segment_parts == [0, 2, 5]
        held |= set(pl.state_dict())
        kinds = [type(m).__name__ for m, _ in pl.run_function]
        assert kinds == (["LlamaEmbeddingPipe", "LlamaDecoderLayer"]
                         if stage == 0 else
                         ["LlamaDecoderLayer", "LlamaRMSNorm",
                          "LlamaLMHeadPipe"])
    assert held == names
    with pytest.raises(ValueError, match="untied"):
        LlamaForCausalLMPipe(LlamaConfig(**TINY, tie_word_embeddings=True),
                             device="cpu", num_stages=2, stage_id=0)


@pytest.mark.parametrize("world", list(WORLDS))
def test_llama_pipe_trains_as_the_reference(worlds, world):
    ranks, want, _ = worlds
    pp, mp = WORLDS[world]
    by = {}
    for out in ranks[world]:
        assert out["wrapper"] == "PipelineParallel"
        gap = np.abs(out["losses"] - want["losses"]).max()
        assert gap < LOSS_BAR, (world, out["losses"], want["losses"])
        _, stage, r = out["coords"]
        by[(stage, r)] = out["state"]
    joined = {}
    for stage in range(pp):
        model = LlamaForCausalLMPipe(LlamaConfig(**TINY), device="cpu",
                                     num_stages=pp, stage_id=stage,
                                     mp_group=_stand_in(mp, 0))
        plan = convert.mp_plan(model)
        states = [by[(stage, r)] for r in range(mp)]
        for k in states[0]:
            if k not in plan:        # replicated: alike over mp
                for st in states[1:]:
                    np.testing.assert_array_equal(st[k], states[0][k])
        joined.update(convert.mp_state_dict_to_jax(
            [{k: torch.from_numpy(v) for k, v in st.items()}
             for st in states], model, plan=plan))
    assert set(joined) == set(want["params"])
    for k, v in want["params"].items():
        assert _rel(joined[k], v) < REL_BAR, (world, k)
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("world", list(HYBRID))
def test_llama_that_is_no_pipe_trains_whole_on_every_pp_rank(worlds,
                                                             world):
    ranks, ref, _ = worlds
    want = ref["hybrid"]
    pp, mp = HYBRID[world]
    by = {}
    for out in ranks[world]:
        assert out["types"] == ["HybridParallel",
                                "HybridParallelOptimizer" if mp > 1
                                else "AdamW"]
        gap = np.abs(out["losses"] - want["losses"]).max()
        assert gap < LOSS_BAR, (world, out["losses"], want["losses"])
        by[tuple(out["coords"])] = out["state"]
    for (stage, r), st in by.items():     # the pp ranks are replicas
        for k, v in st.items():
            np.testing.assert_array_equal(v, by[(0, r)][k], err_msg=k)
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu",
                             mp_group=_stand_in(mp, 0))
    joined = convert.mp_state_dict_to_jax(
        [{k: torch.from_numpy(v) for k, v in by[(0, r)].items()}
         for r in range(mp)], model)
    assert set(joined) == set(want["params"])
    for k, v in want["params"].items():
        assert _rel(joined[k], v) < REL_BAR, (world, k)
    assert want["losses"][-1] < want["losses"][0]
