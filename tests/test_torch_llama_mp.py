"""LLaMA under the mp axis: the port's `llama_sharding_rules` realised as
Megatron blocks, in gloo ranks on the CPU (`llama_selftest`, no jax),
against the JAX package's LLaMA whose parameters are placed by its
``llama_sharding_rules`` on a CPU mesh, exactly as
``tests/test_llama_bert.py::test_config5_tp_pp_sp_slice`` places them
(minus its sep axis), trained by its ``TrainStep``.

The tiny LLaMA is the reference test's ``_tiny_llama`` (vocab 64, hidden
32, 2 layers, 4 heads over 2 KV heads; 4 KV heads at mp 4). Global
weights are drawn with numpy from a seed in the reference's layouts;
rank r takes its blocks through `convert.mp_state_dict_from_jax`, and
the ranks' parameters are joined back with `convert.mp_state_dict_to_jax`.
The worlds: mp 2, mp 4 and dp 2 x mp 2 (each data rank on its rows),
each with tied and untied heads: 3 steps of AdamW with an active
``ClipGradByGlobalNorm`` (Adam's epsilon 1e-3, so the update follows the
clip's scale) through ``fleet.distributed_model(llama).train_step``.
Bars: loss |diff| < 5e-4 each step, parameters relative < 5e-3 (the
reference's training bars), logits 1e-5. Also:

* `llama_sharding_rules` is the reference's list, and `match_sharding`
  gives each parameter the reference's spec;
* the rules' column / row placement is `assign_roles`' on the port's
  LLaMA (as tests/test_distributed.py holds the reference's table to
  its hand rules);
* a model drawn from a seed under mp holds the world of one's tensors,
  block for block;
* ``amp.decorate(level="O2")`` with recompute under mp against the
  port's world of one in this process (bf16: loss 2e-3, masters 1e-2
  relative in norm, `test_torch_llama`'s bf16 bars);
* parameters and AdamW moments through the mp maps and back, bit for
  bit;
* the refusals: dims that do not divide by the degree; ring attention
  beside mp runs under sep (`test_torch_sep_hybrid.py`), and beside a
  pp degree as a model that is no `PipelineLayer` still raises, naming
  A9b.5b.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.optimizer as popt
from paddle_tpu.distributed import env as jenv
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu.models.gpt import match_sharding as jmatch
from paddle_tpu.models.llama import (
    llama_sharding_rules as jllama_sharding_rules)
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import decorate
from paddle_tpu_torch.distributed.fleet.layers.mpu import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.distributed.fleet.layers.mpu.roles import assign_roles
from paddle_tpu_torch.distributed.llama_selftest import start
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama_sharding_rules, match_sharding)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=32, intermediate_size=48)
STEPS, LR, CLIP, EPS = 3, 1e-2, 0.1, 1e-3
LOSS_BAR, REL_BAR, LOGIT_BAR = 5e-4, 5e-3, 1e-5
BF16_LOSS_BAR, BF16_REL_BAR = 2e-3, 1e-2
# (dp, mp, the config's overrides) of each world
WORLDS = {"mp2": (1, 2, {}), "mp4": (1, 4, {"num_key_value_heads": 4}),
          "dp2mp2": (2, 2, {})}
HEADS = ("tied", "untied")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _named(cfg, seed):
    """Numpy weights of the reference's names and layouts."""
    paddle.seed(0)
    jm = JModel(JConfig(**cfg))
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        out[name] = 1.0 + 0.1 * a if p.ndim == 1 else 0.1 * a
    return out


def _args(world):
    dp, mp, over = WORLDS[world]
    cfg = {**TINY, **over}
    rng = np.random.default_rng(1)
    return {"config": cfg, "mp": mp, "heads": HEADS, "steps": STEPS,
            "lr": LR, "clip": CLIP, "eps": EPS, "seed": 11,
            "named": {h: _named({**cfg, "tie_word_embeddings": h == "tied"},
                                2) for h in HEADS},
            "ids": rng.integers(0, 64, (4, 16)),
            "labels": rng.integers(0, 64, (4, 16)), "o2": True}


def _place(model, mesh):
    """test_config5_tp_pp_sp_slice's placement by the rules."""
    rules = jllama_sharding_rules(tp_axis="mp")
    for name, p in model.named_parameters():
        spec = jmatch(name, rules) or ()
        axes = [ax if (ax and p._data.shape[i] % mesh.shape[ax] == 0)
                else None for i, ax in enumerate(spec)]
        p._data = jax.device_put(
            p._data, NamedSharding(mesh, P(*axes) if axes else P()))


def _reference(world, a, head):
    """The reference's 3 placed `TrainStep`s: logits, losses, final
    parameters and the optimizer."""
    dp, mp, _ = WORLDS[world]
    devs = np.array(jax.devices("cpu")[:dp * mp])
    mesh = (Mesh(devs.reshape(dp, mp), ("dp", "mp")) if dp > 1
            else Mesh(devs, ("mp",)))
    jenv.reset()
    jenv.set_mesh(mesh)
    try:
        paddle.seed(0)
        jm = JModel(JConfig(**a["config"],
                            tie_word_embeddings=head == "tied"))
        for name, p in jm.named_parameters():
            p._data = jnp.asarray(a["named"][head][name])
        _place(jm, mesh)
        jm.train()
        ids = paddle.to_tensor(a["ids"], dtype="int64")
        labels = paddle.to_tensor(a["labels"], dtype="int64")
        logits = np.asarray(jm(paddle.to_tensor(a["ids"][:1],
                                                dtype="int64"))._data)
        if dp > 1:
            for t in (ids, labels):
                t._data = jax.device_put(t._data,
                                         NamedSharding(mesh, P("dp", None)))
        crit = JCrit()
        opt = popt.AdamW(learning_rate=LR, epsilon=EPS, weight_decay=0.01,
                         parameters=jm.parameters(), grad_clip=JClip(CLIP))
        step = JTrainStep(jm, lambda m, i, l: crit(m(i), l), opt)
        losses = [float(step(ids, labels)) for _ in range(STEPS)]
        assert "mp" in str(
            jm.llama.layers[0].self_attn.q_proj.weight._data.sharding)
        params = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        return {"logits": logits, "losses": np.asarray(losses),
                "params": params, "model": jm, "opt": opt}
    finally:
        jenv.reset()


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    name = request.param
    dp, mp, _ = WORLDS[name]
    a = _args(name)
    job = start("llama_mp", dp * mp, a, timeout=60)
    try:
        ref = {h: _reference(name, a, h) for h in HEADS}
    finally:
        ranks = job.wait(deadline=120)
    return name, ranks, ref, a


def _port(cfg, **kw):
    return LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", **kw)


def _stand_in(n, r):
    """What the model reads of a model-parallel group to place its blocks
    (its degree and rank): enough to build rank r without processes."""
    return SimpleNamespace(nranks=n, rank=r)


def test_rules_are_the_reference_s():
    assert llama_sharding_rules() == jllama_sharding_rules()
    assert llama_sharding_rules("tp", "fsdp") == jllama_sharding_rules(
        "tp", "fsdp")
    for tied in (True, False):
        cfg = {**TINY, "tie_word_embeddings": tied}
        paddle.seed(0)
        jm = JModel(JConfig(**cfg))
        tm = _port(cfg)
        assert [n for n, _ in tm.named_parameters()] == \
            [n for n, _ in jm.named_parameters()]
        for name, _ in tm.named_parameters():
            assert match_sharding(name, llama_sharding_rules()) == jmatch(
                name, jllama_sharding_rules()), name


@pytest.mark.parametrize("tied", [True, False])
def test_rules_place_as_assign_roles(tied):
    """The rules' column / row Linears are `assign_roles`' on the port's
    LLaMA (mirroring tests/test_distributed.py:846-870), and the model
    built under mp holds the matching mpu layers."""
    cfg = {**TINY, "tie_word_embeddings": tied}
    tm = _port(cfg)
    blocks = _port(cfg, mp_group=_stand_in(2, 1))
    plan = convert.mp_plan(blocks)
    roles = assign_roles(tm)
    names = {id(m): n for n, m in tm.named_modules()}
    checked = 0
    for key, role in roles.items():
        name = f"{names[key]}.weight"
        assert plan[name] == ("split", 0 if role == "column" else 1), name
        checked += 1
    assert checked == 7 * TINY["num_layers"] + (not tied)
    assert plan["llama.embed_tokens.weight"] == ("split", 0)
    assert len(plan) == checked + 1
    for name, _ in tm.named_parameters():     # the rules' mp entries
        assert (name in plan) == ("mp" in match_sharding(
            name, llama_sharding_rules())), name
    kinds = {ColumnParallelLinear: "column", RowParallelLinear: "row"}
    for name, m in blocks.named_modules():
        if type(m) in kinds:
            want = ("split", 0 if kinds[type(m)] == "column" else 1)
            assert plan[f"{name}.weight"] == want, name
            assert m.weight.is_distributed is True
    assert type(blocks.llama.embed_tokens) is VocabParallelEmbedding
    attn = blocks.llama.layers[0].self_attn
    assert (attn.num_heads, attn.num_kv_heads, attn.head_dim) == (2, 1, 8)


def _joined(ranks, get, model):
    """The dp rank 0's mp ranks' states (``get(rank's result)``) joined
    into the reference's arrays; the dp ranks' states equal, the
    replicated parameters equal over mp."""
    by = {tuple(out["coords"]): get(out) for out in ranks}
    dp = 1 + max(c[0] for c in by)
    mp = 1 + max(c[1] for c in by)
    states = [by[(0, r)] for r in range(mp)]
    for (d, r), st in by.items():
        for k, v in st.items():
            np.testing.assert_array_equal(v, states[r][k], err_msg=k)
    plan = convert.mp_plan(model)
    for k in states[0]:
        if k not in plan:
            for st in states[1:]:
                np.testing.assert_array_equal(st[k], states[0][k],
                                              err_msg=k)
    return convert.mp_state_dict_to_jax(
        [{k: torch.from_numpy(v) for k, v in st.items()} for st in states],
        model)


@pytest.mark.parametrize("head", HEADS)
def test_llama_mp_trains_as_the_placed_reference(world, head):
    name, ranks, ref, a = world
    _, mp, _ = WORLDS[name]
    want = ref[head]
    for out in ranks:
        got = out[head]
        assert got["types"] == ["TensorParallel", "TrainStep",
                                "HybridParallelOptimizer"]
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=LOGIT_BAR)
        gap = np.abs(got["losses"] - want["losses"]).max()
        assert gap < LOSS_BAR, (got["losses"], want["losses"])
    cfg = {**a["config"], "tie_word_embeddings": head == "tied"}
    joined = _joined(ranks, lambda out: out[head]["state"],
                     _port(cfg, mp_group=_stand_in(mp, 0)))
    assert set(joined) == set(want["params"])
    for k, v in want["params"].items():
        assert _rel(joined[k], v) < REL_BAR, k
    # the clip was active: its scale moved every step
    assert want["losses"][-1] < want["losses"][0]


def test_seeded_blocks_are_the_world_of_one_s(world):
    name, ranks, _, a = world
    _, mp, _ = WORLDS[name]
    joined = _joined(ranks, lambda out: out["seeded"],
                     _port(a["config"], mp_group=_stand_in(mp, 0)))
    one = _port(a["config"], seed=a["seed"])
    want = convert.state_dict_to_jax(one.state_dict(), model=one)
    assert set(joined) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(joined[k], v, err_msg=k)


def test_o2_and_recompute_compose_with_mp(world):
    """bf16 O2 with recompute under mp against the port's world of one
    on the same weights (`test_torch_llama`'s bf16 bars)."""
    name, ranks, _, a = world
    _, mp, _ = WORLDS[name]
    cfg = LlamaConfig(**a["config"], use_recompute=True)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(a["named"]["untied"],
                                                   model=tm))
    tm.train()
    opt = AdamW(learning_rate=LR, epsilon=EPS, weight_decay=0.01,
                parameters=tm.parameters(),
                grad_clip=ClipGradByGlobalNorm(CLIP))
    tm, opt = decorate(models=tm, optimizers=opt, level="O2")
    step = TrainStep(tm, lambda m, x, y: m.loss(x, y), opt, numerics=False)
    ids, labels = (torch.from_numpy(a[k]) for k in ("ids", "labels"))
    losses = np.asarray([float(step(ids, labels)) for _ in range(STEPS)])
    masters = {n: opt._master_weights[p].numpy()
               for n, p in tm.named_parameters()}
    for out in ranks:
        assert np.abs(out["o2"]["losses"] - losses).max() < BF16_LOSS_BAR
    joined = _joined(ranks, lambda out: out["o2"]["masters"],
                     _port(a["config"], mp_group=_stand_in(mp, 0)))
    want = convert.state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in masters.items()}, model=tm)
    for k, v in want.items():
        rel = np.linalg.norm(joined[k] - v) / np.linalg.norm(v)
        assert rel < BF16_REL_BAR, (k, rel)


def test_weights_and_adamw_state_round_trip_bit_for_bit(world, tmp_path):
    """The reference's parameters and AdamW state after its steps ->
    every mp rank's blocks (`mp_state_dict_from_jax`,
    `optimizer_state_from_jax(rank=, degree=)`) -> joined
    (`mp_state_dict_to_jax`, `mp_optimizer_state_to_jax`): the input,
    bit for bit."""
    name, _, ref, a = world
    _, mp, _ = WORLDS[name]
    want = ref["untied"]
    path = str(tmp_path / "llama.pdparams")
    paddle.save({"model": want["model"].state_dict(),
                 "opt": want["opt"].state_dict()}, path)
    ck = pt.load(path)
    names = {n: p.name for n, p in want["model"].named_parameters()}
    models, opts = [], []
    for r in range(mp):
        m = _port(a["config"], mp_group=_stand_in(mp, r))
        m.load_state_dict(convert.mp_state_dict_from_jax(ck["model"], m, r,
                                                         mp))
        o = AdamW(learning_rate=LR, parameters=m.parameters())
        o.set_state_dict(convert.optimizer_state_from_jax(
            ck["opt"], m, o, rank=r, degree=mp))
        models.append(m)
        opts.append(o)
    back = convert.mp_state_dict_to_jax([m.state_dict() for m in models],
                                        models[0])
    for k, v in ck["model"].items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    state = convert.mp_optimizer_state_to_jax(
        [o.state_dict() for o in opts], models, opts, names=names)
    src = ck["opt"]
    assert set(state["accumulators"]) == set(src["accumulators"])
    for acc, store in src["accumulators"].items():
        assert set(state["accumulators"][acc]) == set(store)
        for key, v in store.items():
            np.testing.assert_array_equal(state["accumulators"][acc][key],
                                          np.asarray(v), err_msg=key)
    moments = [k for k in src["accumulators"] if "moment" in k]
    assert len(moments) == 2


@pytest.mark.parametrize("dim,over", [
    ("num_attention_heads", dict(num_attention_heads=2,
                                 num_key_value_heads=2, hidden_size=32)),
    ("num_key_value_heads", {}),
    ("intermediate_size", dict(intermediate_size=50,
                               num_key_value_heads=4)),
    ("vocab_size", dict(vocab_size=66, num_key_value_heads=4)),
])
def test_dims_that_do_not_split_are_refused(dim, over):
    """The reference's GSPMD leaves such a dim whole; the port raises,
    naming it (mp 4: KV heads 2 do not split)."""
    with pytest.raises(ValueError, match=dim):
        _port({**TINY, **over}, mp_group=_stand_in(4, 0))


def test_ring_attention_still_names_its_queue_entry():
    """Ring attention is ported (A9b.5) and runs beside mp (A9b.5b's
    first part, `test_torch_sep_hybrid.py`); a LLaMA with it beside mp
    that is no `PipelineLayer` at pp x sep raises, naming its queue
    entry, A9b.5b (`LlamaForCausalLMPipe` runs there)."""
    from paddle_tpu_torch.distributed.fleet import fleet, topology

    model = _port({**TINY, "use_ring_attention": True},
                  mp_group=_stand_in(2, 0))
    hcg = SimpleNamespace(
        get_sep_parallel_world_size=lambda: 2,
        get_pipe_parallel_world_size=lambda: 2,
        get_sep_parallel_group=lambda: _stand_in(2, 0),
        get_model_parallel_group=lambda: _stand_in(2, 0))
    held = fleet._hcg
    topology.set_hybrid_communicate_group(hcg)
    fleet._hcg = hcg
    try:
        with pytest.raises(NotImplementedError, match=r"A9b\.5b"):
            fleet.distributed_model(model)
    finally:
        topology.set_hybrid_communicate_group(None)
        fleet._hcg = held
