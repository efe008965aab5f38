"""The ``scan_layers`` GPT (`models.gpt.GPTStackedBlocks`) and the "dots"
recompute policy of the PyTorch port against the JAX package.

Weights are drawn with numpy, set on the reference's scan model and
carried into the port's by `convert`. Bars: the loss within 1e-5 and
every gradient within 1e-4 of its largest magnitude (fp32, the same
algorithm: tests/test_torch_train.py's bars); the recompute policies
against each other and against no recompute 1e-6 relative (fp32, the
same products in the same order).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JModel
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

TINY = dict(vocab_size=96, hidden_size=32, num_layers=3,
            num_attention_heads=2, max_position_embeddings=16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _pair(tie=True, seed=0):
    paddle.seed(0)
    jm = JModel(JConfig(**TINY, scan_layers=True, tie_word_embeddings=tie))
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jm.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        a = 1.0 + 0.1 * a if "ln" in name and name.endswith("weight") \
            else 0.1 * a
        p._data = jnp.asarray(a)
        named[name] = a
    tm = GPTForCausalLM(GPTConfig(**TINY, scan_layers=True,
                                  tie_word_embeddings=tie), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(named, model=tm))
    jm.train()
    tm.train()
    return jm, tm, named


def _batch(segments=False):
    rng = np.random.default_rng(1)
    v, s = TINY["vocab_size"], TINY["max_position_embeddings"]
    ids, labels = rng.integers(0, v, (2, s)), rng.integers(0, v, (2, s))
    seg = (np.stack([np.repeat([0, 1], [7, s - 7]), np.zeros(s, np.int64)])
           .astype(np.int32) if segments else None)
    return ids, labels, seg


@pytest.mark.parametrize("tie", [True, False])
def test_stacked_names_and_shapes_are_the_reference(tie):
    """The same ``named_parameters()`` names in the same order; a stacked
    Linear weight is ``[L, out, in]`` (the reference's ``[L, in, out]``
    with its last two axes swapped); the round trip through `convert` is
    bit-exact."""
    jm, tm, named = _pair(tie)
    jnames = [(n, tuple(p.shape)) for n, p in jm.named_parameters()]
    tnames = [(n, tuple(p.shape)) for n, p in tm.named_parameters()]
    assert [n for n, _ in jnames] == [n for n, _ in tnames]
    linear = convert.linear_weights(tm)
    assert {n for n, _ in tnames if n.endswith(("qkv__weight",
                                                "out_proj__weight",
                                                "fc1__weight",
                                                "fc2__weight"))} <= linear
    assert linear == convert.linear_weights(names=[n for n, _ in tnames])
    for (n, js), (_, ts) in zip(jnames, tnames):
        want = js[:-2] + js[-2:][::-1] if n in linear else js
        assert ts == want, n
    back = convert.state_dict_to_jax(tm.state_dict(), model=tm)
    assert set(back) == set(named)
    for n, a in named.items():
        assert np.array_equal(back[n], a), n
    assert not list(tm.gpt.blocks.children())   # the template is unlisted
    assert all(p.is_meta for p in tm.gpt.blocks._template.parameters())


@pytest.mark.parametrize("tie,segments", [(True, True), (False, False)])
def test_scan_model_loss_and_grads_match_the_reference(tie, segments):
    jm, tm, _ = _pair(tie)
    ids, labels, seg = _batch(segments)
    jl = jm.loss(paddle.to_tensor(ids, dtype="int64"),
                 paddle.to_tensor(labels, dtype="int64"),
                 segment_ids=(None if seg is None
                              else paddle.to_tensor(seg, dtype="int32")))
    jl.backward()
    tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels),
                 segment_ids=None if seg is None else torch.from_numpy(seg))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    jgrads = convert.state_dict_from_jax(
        {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()},
        model=tm)
    for name, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), jgrads[name].numpy()) < 1e-4, name


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("scan", [True, False])
def test_dots_policy_keeps_the_products_and_gives_the_same_grads(scan):
    """"dots" (selective checkpoint) against full recompute and against
    no recompute: the same grads (fp32, 1e-6 relative); its backward
    runs no matrix product of the forward again (as many as without
    recompute), which full recompute does."""
    _, ref, _ = _pair()
    ids, labels, _ = _batch()
    out = {}
    for mode in ("none", "full", "dots"):
        tm = GPTForCausalLM(GPTConfig(
            **TINY, scan_layers=scan, use_recompute=mode != "none",
            recompute_policy="dots" if mode == "dots" else None),
            device="cpu")
        sd = ref.state_dict()
        if not scan:
            sd = {k: v for k, v in tm.state_dict().items()}
            for flat, pname in ref.gpt.blocks._stacked_names:
                stacked = getattr(ref.gpt.blocks, flat).detach()
                for i in range(TINY["num_layers"]):
                    sd[f"gpt.blocks.{i}.{pname}"] = stacked[i]
            for n, v in ref.state_dict().items():
                if "blocks" not in n:
                    sd[n] = v
        tm.load_state_dict(sd)
        tm.train()
        loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
        with _CountMatmuls() as count:
            loss.backward()
        out[mode] = ({n: p.grad.clone() for n, p in tm.named_parameters()},
                     count.n)
    assert out["full"][1] > out["none"][1]
    assert out["dots"][1] == out["none"][1]
    for mode in ("full", "dots"):
        for n, g in out[mode][0].items():
            assert _rel(g, out["none"][0][n]) < 1e-6, (mode, n)


def test_dropout_under_recompute_draws_the_forward_masks():
    """Hidden dropout inside checkpointed layers (scan model, both
    policies): the backward's replay restores the generator state, so
    the grads equal those of one stored forward from the same seed."""
    _, ref, _ = _pair()
    ids, labels, _ = _batch()
    grads = {}
    for policy in (None, "full", "dots"):
        tm = GPTForCausalLM(GPTConfig(
            **TINY, scan_layers=True, hidden_dropout_prob=0.2,
            use_recompute=policy is not None, recompute_policy=policy),
            device="cpu")
        tm.load_state_dict(ref.state_dict())
        tm.train()
        torch.manual_seed(5)
        tm.loss(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
        grads[policy] = {n: p.grad for n, p in tm.named_parameters()}
    for policy in ("full", "dots"):
        for n, g in grads[policy].items():
            assert _rel(g, grads[None][n]) < 1e-6, (policy, n)


def test_init_draws_as_the_reference_does():
    """normal(0, 0.02) for stacked matrices, the residual projections
    scaled by 1/sqrt(2 L), zero biases and unit LayerNorm scales (read
    from a larger model's statistics)."""
    cfg = GPTConfig(vocab_size=96, hidden_size=128, num_layers=4,
                    num_attention_heads=2, scan_layers=True)
    tm = GPTForCausalLM(cfg, device="cpu", seed=1).requires_grad_(False)
    b = tm.gpt.blocks
    resid = 0.02 / (2.0 * 4) ** 0.5
    assert abs(float(b.blocks__attn__qkv__weight.std()) - 0.02) < 1e-3
    assert abs(float(b.blocks__mlp__fc2__weight.std()) - resid) < 5e-4
    assert abs(float(b.blocks__attn__out_proj__weight.std()) - resid) < 5e-4
    assert torch.equal(b.blocks__ln_1__weight, torch.ones(4, 128))
    assert torch.equal(b.blocks__mlp__fc1__bias, torch.zeros(4, 512))
    # each layer's slice draws its own values
    w = b.blocks__attn__qkv__weight
    assert not torch.equal(w[0], w[1])


def test_scan_model_refuses_decoding_and_unknown_policies():
    _, tm, _ = _pair()
    with pytest.raises(NotImplementedError, match="scan_layers"):
        tm.generate(np.zeros((1, 4), np.int64), max_new_tokens=2)
    with pytest.raises(NotImplementedError, match="scan_layers"):
        tm.gpt.decode_step(torch.zeros(1, 1, dtype=torch.long), None,
                           torch.zeros(1, 1, dtype=torch.long))
    with pytest.raises(ValueError, match="recompute policy"):
        GPTConfig(**TINY, recompute_policy="dotz")
    # the reference's aliases of full recompute
    for p in ("full", "nothing"):
        GPTConfig(**TINY, recompute_policy=p)
    # eval mode reaches the template (not a registered submodule)
    tm.eval()
    ids, _, _ = _batch()
    with torch.no_grad():
        a = tm(torch.from_numpy(ids))
        b = tm(torch.from_numpy(ids))
    assert torch.equal(a, b)
