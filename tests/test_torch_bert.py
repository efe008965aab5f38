"""The port's BERT family against the JAX package's
(paddle_tpu/models/bert.py), at the reference test's tiny BERT
(tests/test_llama_bert.py ``TestBertConfig3``: vocab 64, hidden 32, 2
layers, 4 heads, 32 positions, dropout 0).

Weights are drawn with numpy from a seed, set on the reference model and
carried into the port by `convert.state_dict_from_jax`; batches are numpy
arrays handed to both, with padding masks of four lengths. Bars:

* both heads' logits within 2e-5 (fp32);
* padding invariance: a row's pooled output moves by at most 1e-5 when
  its padded tokens change (the reference test's bar);
* 3 AdamW steps (the port through ``TrainStep``, the reference through
  its eager loop): loss |diff| < 5e-4 each step, parameters relative
  < 5e-3 (the reference's bars, tests/test_training_kernels.py);
* ``amp.decorate(level="O2")`` on both sides, the fine-tune head at lr
  1e-3: the reference takes one step and the port loads its state (so
  both start from the same moments: Adam's first step turns rounding
  noise into lr-sized moves), then both take 3 steps. The bars of
  test_torch_llama.py for the update: masters relative < 1e-2, each
  parameter's update within 0.25 of the reference update's norm
  (measured at most 0.033), and the update moved a layer along must miss
  that bar (measured 0.65). The keys' bias (the middle third of
  ``qkv.bias``) is left out of the update bar: softmax ignores a
  constant added to a row's scores, so its gradient is 0 up to
  rounding, and Adam moves it by about lr a step whatever that rounding
  is. The loss is held to one bf16 ulp of the largest logit, not to
  LLaMA's 2e-3: at O2 the two packages round at other points (the
  Linear's bias, GELU's ops), so 25-75% of the bf16 logits differ by 1
  or 2 ulps on the same weights, and at logits in [1, 2) one ulp is
  0.0078 (measured loss gap 2.2e-3);
* checkpoint files with AdamW state bit for bit both ways.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as popt
from paddle_tpu.amp import decorate as jdecorate
from paddle_tpu.models import BertConfig as JConfig
from paddle_tpu.models import BertForPretraining as JPretraining
from paddle_tpu.models import BertForSequenceClassification as JClassifier
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import decorate
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BERT_CONFIGS, BertConfig,
                                     BertForPretraining,
                                     BertForSequenceClassification,
                                     BertModel, bert_config)
from paddle_tpu_torch.nn import CrossEntropyLoss, LayerNorm
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LOSS_BAR, REL_BAR = 5e-4, 5e-3
BF16_REL_BAR, BF16_UPDATE_BAR = 1e-2, 0.25
HEADS = {"classifier": (JClassifier, BertForSequenceClassification,
                        {"num_classes": 3}),
         "pretraining": (JPretraining, BertForPretraining, {})}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def make_models(head, seed=0, **over):
    """(reference model, port model), the same numpy weights, both in
    training mode."""
    jcls, tcls, kw = HEADS[head]
    cfg = {**TINY, **over}
    paddle.seed(0)
    jm = jcls(JConfig(**cfg), **kw)
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        a = 1.0 + 0.1 * a if p.ndim == 1 else 0.1 * a
        p._data = jnp.asarray(a)
        named[name] = a
    tm = tcls(BertConfig(**cfg), device="cpu", **kw)
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    jm.train()
    tm.train()
    return jm, tm


def batch(head, b=4, s=16, seed=2):
    """ids, a 1/0 padding mask of lengths s, 12, 9 and 5, and the labels:
    the classes, or the MLM tokens and the NSP labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (b, s))
    mask = (np.arange(s)[None] < np.array([s, 12, 9, 5])[:b, None]).astype(
        np.int64)
    if head == "classifier":
        return ids, mask, rng.integers(0, 3, (b,))
    return (ids, mask, rng.integers(0, TINY["vocab_size"], (b, s)),
            rng.integers(0, 2, (b,)))


def jloss(head):
    """The reference's loss: CE over the classes, or the MLM CE plus the
    NSP CE."""
    ce = jnn.CrossEntropyLoss()

    def fn(m, ids, mask, *labels):
        out = m(ids, attention_mask=mask)
        if head == "classifier":
            return ce(out, labels[0])
        return ce(out[0].reshape([-1, TINY["vocab_size"]]),
                  labels[0].reshape([-1])) + ce(out[1], labels[1])
    return fn


def tloss(head):
    ce = CrossEntropyLoss()

    def fn(m, ids, mask, *labels):
        out = m(ids, attention_mask=mask)
        if head == "classifier":
            return ce(out, labels[0])
        return ce(out[0].reshape(-1, TINY["vocab_size"]),
                  labels[0].reshape(-1)) + ce(out[1], labels[1])
    return fn


def _run(head, jm, tm, jopt, topt, arrays, steps=3):
    """The reference's eager loop and the port's ``TrainStep``: their
    losses."""
    ja = [paddle.to_tensor(a, dtype="int64") for a in arrays]
    fn = jloss(head)
    jl = []
    for _ in range(steps):
        loss = fn(jm, *ja)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss))
    step = TrainStep(tm, tloss(head), topt)
    ta = [torch.from_numpy(a) for a in arrays]
    return jl, [float(step(*ta)) for _ in range(steps)]


def _jax_params(jm, tm, store=None):
    """The reference's parameters (or, with ``store``, its fp32 masters
    where it keeps one) under the port's names and layouts."""
    return {k: v.float().numpy() for k, v in convert.state_dict_from_jax(
        {n: np.asarray((store or {}).get(p.name, p._data).astype(
            jnp.float32)) for n, p in jm.named_parameters()},
        model=tm).items()}


# ---------------------------------------------------------------------------
# 1. the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", list(HEADS))
def test_names_and_creation_order_are_the_reference(head):
    jm, tm = make_models(head)
    counter = [n for n, p in sorted(jm.named_parameters(),
                                    key=lambda x: int(x[1].name[6:]))]
    assert [n for n, _ in tm.named_parameters()] == counter
    assert list(tm.state_dict()) == list(jm.state_dict())


@pytest.mark.parametrize("head", list(HEADS))
def test_forward_logits_match_jax(head):
    jm, tm = make_models(head)
    ids, mask = batch(head)[:2]
    want = jm(paddle.to_tensor(ids, dtype="int64"),
              attention_mask=paddle.to_tensor(mask, dtype="int64"))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._data), rtol=0,
                                   atol=2e-5)


def test_padding_does_not_reach_the_pooled_output():
    _, tm = make_models("classifier")
    tm.eval()
    ids, mask = batch("classifier")[:2]
    moved = ids.copy()
    moved[1, 12:] = (moved[1, 12:] + 7) % TINY["vocab_size"]
    with torch.no_grad():
        a = tm.bert(torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask))[1]
        b = tm.bert(torch.from_numpy(moved),
                    attention_mask=torch.from_numpy(mask))[1]
    assert float((a[1] - b[1]).abs().max()) <= 1e-5
    assert float((a[0] - b[0]).abs().max()) == 0.0


def test_a_four_dim_mask_passes_as_it_is():
    """A ``[b, 1, 1, s]`` additive mask is the 2-D mask's own form."""
    _, tm = make_models("classifier")
    ids, mask = batch("classifier")[:2]
    add = (1.0 - torch.from_numpy(mask).float())[:, None, None, :] * -1e9
    with torch.no_grad():
        a = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
        b = tm(torch.from_numpy(ids), attention_mask=add)
    assert torch.equal(a, b)


def test_configs_initialisation_and_the_dropout_generator():
    base = bert_config("bert-base")
    assert (base.vocab_size, base.hidden_size, base.num_layers,
            base.num_attention_heads, base.intermediate_size) == (
        30522, 768, 12, 12, 3072)
    assert set(BERT_CONFIGS) == {"bert-base", "bert-large"}
    cfg = BertConfig(**{**TINY, "hidden_size": 64, "vocab_size": 512})
    a = BertModel(cfg, device="cpu", seed=3)
    b = BertModel(cfg, device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    for name, p in a.named_parameters():
        if p.ndim >= 2:
            assert abs(float(p.detach().std()) / 0.02 - 1) < 0.1, name
        elif name.endswith("norm.weight"):
            assert p.eq(1).all(), name
        else:
            assert p.eq(0).all(), name
    # the model's dropout generator: the same seed replays the masks
    drop = BertConfig(**{**TINY, "hidden_dropout_prob": 0.1,
                         "attention_dropout_prob": 0.1})
    ids = torch.from_numpy(batch("classifier")[0])
    outs = [BertForSequenceClassification(drop, device="cpu", seed=s)(ids)
            for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    m = BertForSequenceClassification(drop, device="cpu", seed=5)
    m.eval()
    assert torch.equal(m(ids), m(ids))


def test_o2_keeps_the_layer_norms_in_fp32():
    tm = BertForPretraining(BertConfig(**TINY), device="cpu")
    opt = AdamW(parameters=tm.parameters())
    decorate(models=tm, optimizers=opt, level="O2")
    for module in tm.modules():
        for p in module.parameters(recurse=False):
            want = (torch.float32 if isinstance(module, LayerNorm)
                    else torch.bfloat16)
            assert p.dtype == want, type(module).__name__


# ---------------------------------------------------------------------------
# 2. training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", list(HEADS))
def test_train_steps_match_jax(head):
    jm, tm = make_models(head)
    jopt = popt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                      parameters=jm.parameters())
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters())
    jl, tl = _run(head, jm, tm, jopt, topt, batch(head))
    assert max(abs(a - b) for a, b in zip(jl, tl)) < LOSS_BAR, (jl, tl)
    assert tl[-1] < tl[0]
    want = _jax_params(jm, tm)
    for name, p in tm.named_parameters():
        assert _rel(p.detach().numpy(), want[name]) < REL_BAR, name


def _update_gap(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _without_key_bias(name, a):
    h = TINY["hidden_size"]
    if name.endswith("attention.qkv.bias"):
        return np.concatenate([a[:h], a[2 * h:]])
    return a


def test_o2_bf16_matches_jax():
    """The fine-tune head under O2: the reference takes one step, the
    port loads its state (bf16 weights, fp32 masters, moments: bit for
    bit, see the checkpoint test), then both take 3 steps."""
    head = "classifier"
    jm, tm = make_models(head, seed=4)
    jopt = popt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                      parameters=jm.parameters())
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters())
    jdecorate(models=jm, optimizers=jopt, level="O2")
    decorate(models=tm, optimizers=topt, level="O2")
    arrays = batch(head)
    logits = jm(*(paddle.to_tensor(a, dtype="int64") for a in arrays[:2]))
    # one bf16 ulp (8 significant bits) at the largest logit
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(np.asarray(
        logits._data.astype(jnp.float32))).max()))) - 7)
    loss = jloss(head)(jm, *(paddle.to_tensor(a, dtype="int64")
                             for a in arrays))
    loss.backward()
    jopt.step()
    jopt.clear_grad()
    tm.load_state_dict(convert.state_dict_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()},
        model=tm))
    topt.set_state_dict(convert.optimizer_state_from_jax(
        jopt.state_dict(), tm, topt))
    start = _jax_params(jm, tm, jopt._master_weights)
    jl, tl = _run(head, jm, tm, jopt, topt, arrays)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0], tl
    want = _jax_params(jm, tm, jopt._master_weights)
    got = {n: topt._master_weights.get(p, p.detach()).float().numpy()
           for n, p in tm.named_parameters()}
    gaps = {n: _update_gap(_without_key_bias(n, got[n] - start[n]),
                           _without_key_bias(n, want[n] - start[n]))
            for n in got}
    nxt = {n: n.replace("encoder.0.", "encoder.1.") for n in got
           if "encoder.0." in n}
    shifted = min(_update_gap(_without_key_bias(n, got[n] - start[n]),
                              _without_key_bias(m, want[m] - start[m]))
                  for n, m in nxt.items())
    loss_gap = max(abs(a - b) for a, b in zip(jl, tl))
    print(f"O2: loss |diff| {loss_gap!r} (one ulp {ulp!r}), update gap "
          f"{max(gaps.values())!r} (a layer along {shifted!r})")
    assert loss_gap < ulp, (jl, tl)
    assert shifted > BF16_UPDATE_BAR
    for name, p in tm.named_parameters():
        assert gaps[name] < BF16_UPDATE_BAR, (name, gaps[name])
        assert _update_gap(got[name], want[name]) < BF16_REL_BAR, name
        if p.dtype == torch.bfloat16:
            master = topt._master_weights[p]
            assert master.dtype == torch.float32
            assert torch.equal(master.to(torch.bfloat16), p.detach())


# ---------------------------------------------------------------------------
# 3. checkpoint files
# ---------------------------------------------------------------------------

def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes()
        return a.numpy().tobytes()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).tobytes()
    return a.tobytes()


@pytest.mark.parametrize("head", list(HEADS))
def test_checkpoint_with_adamw_state_crosses_bit_for_bit(tmp_path, head):
    """The reference trains 2 steps and saves model and AdamW state; the
    port loads the file bit for bit (the fused ``qkv`` Linear and the
    MLM head's tied word embeddings among them), trains on and saves;
    the reference loads that file bit for bit."""
    jm, tm = make_models(head)
    jopt = popt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                      parameters=jm.parameters())
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters())
    arrays = batch(head)
    ja = [paddle.to_tensor(a, dtype="int64") for a in arrays]
    for _ in range(2):
        loss = jloss(head)(jm, *ja)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
    path = str(tmp_path / "bert.pdparams")
    paddle.save({"model": jm.state_dict(), "opt": jopt.state_dict()}, path)
    ck = pt.load(path)
    tm.load_state_dict(convert.state_dict_from_jax(ck["model"], model=tm))
    topt.set_state_dict(convert.optimizer_state_from_jax(ck["opt"], tm,
                                                         topt))
    want = convert.state_dict_from_jax(
        {n: np.asarray(p._data) for n, p in jm.named_parameters()},
        model=tm)
    for name, p in tm.named_parameters():
        assert _bits(p) == _bits(want[name]), name
    ref = jopt.state_dict()
    linear = convert.linear_weights(tm)
    assert "bert.encoder.0.attention.qkv.weight" in linear
    assert "bert.embeddings.word_embeddings.weight" not in linear
    tparams = dict(tm.named_parameters())
    for name, jp in jm.named_parameters():
        for acc, store in ref["accumulators"].items():
            got = topt._accumulators[acc][tparams[name]]
            got = got.t() if name in linear else got
            assert _bits(got) == _bits(store[jp.name]), (acc, name)
    assert topt._step_count == ref["step"] == 2

    TrainStep(tm, tloss(head), topt)(*(torch.from_numpy(a) for a in arrays))
    names = {n: p.name for n, p in jm.named_parameters()}
    out = str(tmp_path / "port.pdparams")
    pt.save({"model": convert.state_dict_to_jax(tm.state_dict(), model=tm,
                                                tensors=True),
             "opt": convert.optimizer_state_to_jax(topt.state_dict(), tm,
                                                   topt, names=names)}, out)
    back = paddle.load(out)
    jm.set_state_dict(back["model"])
    jopt.set_state_dict(back["opt"])
    tsd = convert.state_dict_to_jax(tm.state_dict(), model=tm)
    for name, p in jm.named_parameters():
        assert _bits(np.asarray(p._data)) == _bits(tsd[name]), name
    mine = convert.optimizer_state_to_jax(topt.state_dict(), tm, topt,
                                          names=names)
    for acc, store in jopt.state_dict()["accumulators"].items():
        for key, v in store.items():
            assert _bits(np.asarray(v)) == _bits(mine["accumulators"][acc][
                key]), (acc, key)
    assert int(np.asarray(jopt.state_dict()["step"])) == \
        topt._step_count == 3
