"""The port's nn layer (`paddle_tpu_torch.nn`) against the JAX package's
(`paddle_tpu.nn`): the same numpy inputs from a seed through both.

* Every ported functional op and layer: fp32 forward within atol 1e-6,
  rtol 1e-5, and the gradients of every float input (and of a layer's
  parameters) through both packages' autodiff, under one random
  cotangent, at the same bars. Each op is a case of one parametrised
  test.
* ``ParamAttr``: initializer, ``learning_rate``, ``regularizer``,
  ``need_clip`` and ``trainable``, each through 3 optimizer steps
  against the reference's, on the per-parameter and the fused paths.
* The initializers by their contract (bounds, moments, fans),
  ``Constant``, ``Assign``, ``Dirac`` and ``Bilinear`` exactly: the
  reference draws with numpy or ``jax.random``.
* The containers' ``state_dict`` keys; dropout by its contract (rate,
  scaling in both modes, one generator's determinism); the token-chunked
  fused CE at ``n_chunks`` 1 and 4 and with ``FLAGS_fused_ce`` off.
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
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.regularizer import L2Decay as JL2Decay
from paddle_tpu_torch import convert, set_flags
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn import initializer as pinit
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
from paddle_tpu_torch.regularizer import L2Decay

ATOL, RTOL = 1e-6, 1e-5


# ---------------------------------------------------------------------------
# inputs: (kind, shape). "f": standard normal, with a gradient; "p":
# uniform in (0.05, 0.95), with a gradient; "u": uniform, no gradient;
# "i<n>": integers in [0, n); "pm": -1 / +1; "b": 0 / 1; "c": normal, no
# gradient
# ---------------------------------------------------------------------------

def _arrays(specs, seed):
    rng = np.random.default_rng(seed)
    out = []
    for kind, shape in specs:
        if kind in ("f", "c"):
            out.append(rng.standard_normal(shape).astype(np.float32))
        elif kind == "p":
            out.append(rng.uniform(0.05, 0.95, shape).astype(np.float32))
        elif kind == "u":
            out.append(rng.uniform(0.05, 0.95, shape).astype(np.float32))
        elif kind.startswith("i"):
            out.append(rng.integers(0, int(kind[1:]), shape).astype(np.int64))
        elif kind == "pm":
            out.append(rng.choice([-1.0, 1.0], shape).astype(np.float32))
        elif kind == "b":
            out.append(rng.integers(0, 2, shape).astype(np.float32))
        else:
            raise ValueError(kind)
    return out


def _grad(kind):
    return kind in ("f", "p")


# name -> (fn(F, *inputs), specs); F is `paddle_tpu.nn.functional` or
# `paddle_tpu_torch.nn.functional`
X = ("f", (3, 4, 5))
FUNCTIONAL = {
    "relu": (lambda F, x: F.relu(x), [X]),
    "relu6": (lambda F, x: F.relu6(3 * x), [X]),
    "sigmoid": (lambda F, x: F.sigmoid(x), [X]),
    "tanh": (lambda F, x: F.tanh(x), [X]),
    "gelu": (lambda F, x: F.gelu(x), [X]),
    "gelu tanh": (lambda F, x: F.gelu(x, approximate=True), [X]),
    "silu": (lambda F, x: F.silu(x), [X]),
    "swish": (lambda F, x: F.swish(x), [X]),
    "mish": (lambda F, x: F.mish(x), [X]),
    "hardswish": (lambda F, x: F.hardswish(4 * x), [X]),
    "hardsigmoid": (lambda F, x: F.hardsigmoid(4 * x), [X]),
    "hardtanh": (lambda F, x: F.hardtanh(x, -0.5, 0.7), [X]),
    "leaky_relu": (lambda F, x: F.leaky_relu(x, 0.2), [X]),
    "elu": (lambda F, x: F.elu(x, 0.7), [X]),
    "selu": (lambda F, x: F.selu(x), [X]),
    "celu": (lambda F, x: F.celu(x, 1.3), [X]),
    "prelu one slope": (lambda F, x, w: F.prelu(x, w), [X, ("f", (1,))]),
    "prelu channels": (lambda F, x, w: F.prelu(x, w), [X, ("f", (4,))]),
    "prelu NHWC": (lambda F, x, w: F.prelu(x, w, data_format="NHWC"),
                   [X, ("f", (5,))]),
    "rrelu eval": (lambda F, x: F.rrelu(x, training=False), [X]),
    "softplus": (lambda F, x: F.softplus(x, beta=2.0, threshold=3.0), [X]),
    "softsign": (lambda F, x: F.softsign(x), [X]),
    "softshrink": (lambda F, x: F.softshrink(x, 0.3), [X]),
    "hardshrink": (lambda F, x: F.hardshrink(x, 0.3), [X]),
    "tanhshrink": (lambda F, x: F.tanhshrink(x), [X]),
    "thresholded_relu": (lambda F, x: F.thresholded_relu(x, 0.2), [X]),
    "log_sigmoid": (lambda F, x: F.log_sigmoid(x), [X]),
    "softmax": (lambda F, x: F.softmax(x, axis=1), [X]),
    "log_softmax": (lambda F, x: F.log_softmax(x), [X]),
    "relu_": (lambda F, x: F.relu_(x), [("c", (3, 4, 5))]),
    "elu_": (lambda F, x: F.elu_(x, 0.5), [("c", (3, 4, 5))]),
    "hardtanh_": (lambda F, x: F.hardtanh_(x, -0.3, 0.4), [("c", (3, 4, 5))]),
    "leaky_relu_": (lambda F, x: F.leaky_relu_(x, 0.3), [("c", (3, 4, 5))]),
    "softmax_": (lambda F, x: F.softmax_(x, axis=0), [("c", (3, 4, 5))]),
    "tanh_": (lambda F, x: F.tanh_(x), [("c", (3, 4, 5))]),
    "thresholded_relu_": (lambda F, x: F.thresholded_relu_(x, 0.1),
                          [("c", (3, 4, 5))]),
    "maxout": (lambda F, x: F.maxout(x, groups=2, axis=1), [X]),
    "glu": (lambda F, x: F.glu(x, axis=1), [X]),
    "linear": (lambda F, x, w, b: F.linear(x, w, b),
               [X, ("f", (5, 6)), ("f", (6,))]),
    "linear no bias": (lambda F, x, w: F.linear(x, w), [X, ("f", (5, 6))]),
    "embedding": (lambda F, i, w: F.embedding(i, w),
                  [("i7", (3, 4)), ("f", (7, 5))]),
    "embedding padding_idx": (lambda F, i, w: F.embedding(i, w,
                                                          padding_idx=2),
                              [("i7", (3, 4)), ("f", (7, 5))]),
    "one_hot": (lambda F, i: F.one_hot(i, 6), [("i6", (3, 4))]),
    "label_smooth": (lambda F, y: F.label_smooth(y, epsilon=0.2),
                     [("f", (3, 6))]),
    "pad constant": (lambda F, x: F.pad(x, [1, 2, 0, 1], value=0.5),
                     [("f", (2, 3, 4, 5))]),
    "pad full rank": (lambda F, x: F.pad(x, [1, 0, 0, 2, 1, 1]), [X]),
    "pad reflect": (lambda F, x: F.pad(x, [2, 1, 1, 2], mode="reflect"),
                    [("f", (2, 3, 4, 5))]),
    "pad replicate": (lambda F, x: F.pad(x, [2, 1, 1, 0],
                                         mode="replicate"),
                      [("f", (2, 3, 4, 5))]),
    "pad circular": (lambda F, x: F.pad(x, [1, 2, 2, 1], mode="circular"),
                     [("f", (2, 3, 4, 5))]),
    "pad NHWC": (lambda F, x: F.pad(x, [1, 2, 0, 1], data_format="NHWC"),
                 [("f", (2, 4, 5, 3))]),
    "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b),
                          [X, X]),
    "normalize": (lambda F, x: F.normalize(x, axis=-1), [X]),
    "normalize p1": (lambda F, x: F.normalize(x, p=1, axis=1), [X]),
    "bilinear": (lambda F, a, b, w, c: F.bilinear(a, b, w, c),
                 [("f", (3, 4)), ("f", (3, 5)), ("f", (6, 4, 5)),
                  ("f", (6,))]),
    "sequence_mask": (lambda F, n: F.sequence_mask(n, maxlen=6),
                      [("i7", (3, 2))]),
    "dropout eval": (lambda F, x: F.dropout(x, 0.3, training=False), [X]),
    "dropout p=0": (lambda F, x: F.dropout(x, 0.0), [X]),
    "layer_norm": (lambda F, x, w, b: F.layer_norm(x, [4, 5], w, b, 1e-5),
                   [X, ("f", (4, 5)), ("f", (4, 5))]),
    "layer_norm no affine": (lambda F, x: F.layer_norm(x, 5), [X]),
    "rms_norm": (lambda F, x, w: F.rms_norm(x, w, 1e-6),
                 [X, ("f", (5,))]),
    "group_norm": (lambda F, x, w, b: F.group_norm(x, 2, 1e-5, w, b),
                   [("f", (2, 4, 3, 3)), ("f", (4,)), ("f", (4,))]),
    "instance_norm": (lambda F, x, w, b: F.instance_norm(x, weight=w,
                                                         bias=b),
                      [("f", (2, 4, 3, 3)), ("f", (4,)), ("f", (4,))]),
    "local_response_norm": (lambda F, x: F.local_response_norm(
        x, 3, alpha=0.1, beta=0.75, k=1.0), [("f", (2, 5, 3, 3))]),
    "batch_norm eval": (lambda F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b, training=False),
        [("f", (4, 3, 2, 2)), ("c", (3,)), ("u", (3,)), ("f", (3,)),
         ("f", (3,))]),
    "cross_entropy": (lambda F, x, y: F.cross_entropy(x, y),
                      [("f", (6, 7)), ("i7", (6,))]),
    "cross_entropy [n, 1] labels sum": (
        lambda F, x, y: F.cross_entropy(x, y, reduction="sum"),
        [("f", (6, 7)), ("i7", (6, 1))]),
    "cross_entropy weight": (
        lambda F, x, y, w: F.cross_entropy(x, y, weight=w),
        [("f", (6, 7)), ("i7", (6,)), ("u", (7,))]),
    "cross_entropy label_smoothing": (
        lambda F, x, y: F.cross_entropy(x, y, label_smoothing=0.1),
        [("f", (6, 7)), ("i7", (6,))]),
    "cross_entropy soft_label": (
        lambda F, x, y: F.cross_entropy(F.softmax(x), F.softmax(y),
                                        soft_label=True),
        [("f", (6, 7)), ("c", (6, 7))]),
    "cross_entropy soft smoothed none": (
        lambda F, x, y: F.cross_entropy(x, F.softmax(y), soft_label=True,
                                        label_smoothing=0.2,
                                        reduction="none"),
        [("f", (6, 7)), ("c", (6, 7))]),
    "cross_entropy axis 1": (
        lambda F, x, y: F.cross_entropy(x, y, axis=1),
        [("f", (3, 7, 4)), ("i7", (3, 4))]),
    "cross_entropy no softmax": (
        lambda F, x, y: F.cross_entropy(x, y, use_softmax=False),
        [("p", (6, 7)), ("i7", (6,))]),
    "nll_loss": (lambda F, x, y: F.nll_loss(F.log_softmax(x), y),
                 [("f", (6, 7)), ("i7", (6,))]),
    "nll_loss weight": (lambda F, x, y, w: F.nll_loss(F.log_softmax(x), y,
                                                      weight=w),
                        [("f", (6, 7)), ("i7", (6,)), ("u", (7,))]),
    "mse_loss": (lambda F, a, b: F.mse_loss(a, b), [X, X]),
    "l1_loss sum": (lambda F, a, b: F.l1_loss(a, b, "sum"), [X, X]),
    "smooth_l1_loss": (lambda F, a, b: F.smooth_l1_loss(a, b, delta=0.5),
                       [X, X]),
    "binary_cross_entropy": (lambda F, p, y, w: F.binary_cross_entropy(
        p, y, w), [("p", (4, 5)), ("b", (4, 5)), ("u", (4, 5))]),
    "bce_with_logits": (lambda F, z, y: F.binary_cross_entropy_with_logits(
        z, y), [("f", (4, 5)), ("b", (4, 5))]),
    "bce_with_logits pos_weight": (
        lambda F, z, y, w, pw: F.binary_cross_entropy_with_logits(
            z, y, weight=w, pos_weight=pw),
        [("f", (4, 5)), ("b", (4, 5)), ("u", (4, 5)), ("u", (5,))]),
    "kl_div": (lambda F, x, y: F.kl_div(F.log_softmax(x), y),
               [("f", (4, 5)), ("p", (4, 5))]),
    "kl_div log_target batchmean": (
        lambda F, x, y: F.kl_div(x, y, reduction="batchmean",
                                 log_target=True),
        [("f", (4, 5)), ("f", (4, 5))]),
    "hinge_embedding_loss": (lambda F, x, y: F.hinge_embedding_loss(x, y),
                             [("f", (4, 5)), ("pm", (4, 5))]),
    "margin_ranking_loss": (lambda F, a, b, y: F.margin_ranking_loss(
        a, b, y, margin=0.1), [("f", (8,)), ("f", (8,)), ("pm", (8,))]),
    "cosine_embedding_loss": (lambda F, a, b, y: F.cosine_embedding_loss(
        a, b, y, margin=0.1), [("f", (6, 5)), ("f", (6, 5)),
                               ("pm", (6,))]),
    "triplet_margin_loss": (lambda F, a, p, n: F.triplet_margin_loss(
        a, p, n), [("f", (6, 5))] * 3),
    "triplet_margin_loss swap p1": (lambda F, a, p, n: F.triplet_margin_loss(
        a, p, n, p=1, swap=True, reduction="sum"), [("f", (6, 5))] * 3),
    "fused_linear_cross_entropy n_chunks 1": (
        lambda F, h, w, y: F.fused_linear_cross_entropy(
            h, w, y, vocab_tiled=False, n_chunks=1),
        [("f", (10, 8)), ("f", (13, 8)), ("i13", (10,))]),
    "fused_linear_cross_entropy n_chunks 4 [H, V]": (
        lambda F, h, w, y: F.fused_linear_cross_entropy(
            h, w, y, transpose_y=False, vocab_tiled=False, n_chunks=4,
            reduction="sum"),
        [("f", (2, 5, 8)), ("f", (8, 13)), ("i13", (2, 5))]),
    "fused_linear_cross_entropy vocab-tiled": (
        lambda F, h, w, y: F.fused_linear_cross_entropy(h, w, y),
        [("f", (10, 8)), ("f", (13, 8)), ("i13", (10,))]),
}


def _to_jax(a, kind):
    return paddle.to_tensor(a, stop_gradient=not _grad(kind))


def _to_torch(a, kind):
    return torch.tensor(a, requires_grad=_grad(kind))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _cotangent(shape, seed=99):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(jout, tout, jins, tins, specs, jparams=(), tparams=(),
           transpose=()):
    want = np.asarray(jout._data)
    got = tout.detach().numpy()
    assert got.shape == want.shape
    if not tout.is_floating_point():
        np.testing.assert_array_equal(got, want)
        return
    _close(got, want.astype(got.dtype), "forward")
    if not (any(_grad(k) for k, _ in specs) or jparams):
        return
    c = _cotangent(want.shape)
    (jout * paddle.to_tensor(c)).sum().backward()
    (tout * torch.from_numpy(c)).sum().backward()
    for i, (kind, _) in enumerate(specs):
        if _grad(kind):
            _close(tins[i].grad.numpy(), np.asarray(jins[i].grad._data),
                   f"grad of input {i}")
    for name, jp in jparams:
        tg = tparams[name].grad
        tg = tg.t() if name in transpose else tg
        _close(tg.numpy(), np.asarray(jp.grad._data), f"grad of {name}")


@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_functional_matches_jax(name):
    fn, specs = FUNCTIONAL[name]
    arrays = _arrays(specs, seed=len(name))
    jins = [_to_jax(a, k) for a, (k, _) in zip(arrays, specs)]
    tins = [_to_torch(a, k) for a, (k, _) in zip(arrays, specs)]
    _check(fn(JF, *jins), fn(PF, *tins), jins, tins, specs)


# name -> (make(nn), specs, eval_mode); a layer's parameters are drawn
# with numpy and set on both sides
LAYERS = {
    "ReLU": (lambda nn: nn.ReLU(), [X], False),
    "ReLU6": (lambda nn: nn.ReLU6(), [X], False),
    "GELU": (lambda nn: nn.GELU(approximate=True), [X], False),
    "Sigmoid": (lambda nn: nn.Sigmoid(), [X], False),
    "Tanh": (lambda nn: nn.Tanh(), [X], False),
    "Silu": (lambda nn: nn.Silu(), [X], False),
    "Swish": (lambda nn: nn.Swish(), [X], False),
    "Mish": (lambda nn: nn.Mish(), [X], False),
    "Hardswish": (lambda nn: nn.Hardswish(), [X], False),
    "Hardsigmoid": (lambda nn: nn.Hardsigmoid(), [X], False),
    "Hardtanh": (lambda nn: nn.Hardtanh(-0.4, 0.6), [X], False),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.1), [X], False),
    "ELU": (lambda nn: nn.ELU(0.5), [X], False),
    "SELU": (lambda nn: nn.SELU(), [X], False),
    "CELU": (lambda nn: nn.CELU(0.8), [X], False),
    "PReLU": (lambda nn: nn.PReLU(4, init=0.1), [X], False),
    "RReLU eval": (lambda nn: nn.RReLU(), [X], True),
    "Softplus": (lambda nn: nn.Softplus(), [X], False),
    "Softsign": (lambda nn: nn.Softsign(), [X], False),
    "Softshrink": (lambda nn: nn.Softshrink(0.2), [X], False),
    "Hardshrink": (lambda nn: nn.Hardshrink(0.2), [X], False),
    "Tanhshrink": (lambda nn: nn.Tanhshrink(), [X], False),
    "ThresholdedReLU": (lambda nn: nn.ThresholdedReLU(0.3), [X], False),
    "LogSigmoid": (lambda nn: nn.LogSigmoid(), [X], False),
    "Softmax": (lambda nn: nn.Softmax(axis=1), [X], False),
    "LogSoftmax": (lambda nn: nn.LogSoftmax(), [X], False),
    "Maxout": (lambda nn: nn.Maxout(2), [X], False),
    "GLU": (lambda nn: nn.GLU(axis=1), [X], False),
    "Identity": (lambda nn: nn.Identity(), [X], False),
    "Linear": (lambda nn: nn.Linear(5, 6), [X], False),
    "Linear no bias": (lambda nn: nn.Linear(5, 6, bias_attr=False), [X],
                       False),
    "Embedding": (lambda nn: nn.Embedding(9, 5, padding_idx=-1),
                  [("i9", (3, 4))], False),
    "Dropout eval": (lambda nn: nn.Dropout(0.4), [X], True),
    "Dropout2D eval": (lambda nn: nn.Dropout2D(0.4), [("f", (2, 3, 4, 4))],
                       True),
    "Dropout3D eval": (lambda nn: nn.Dropout3D(0.4),
                       [("f", (2, 3, 2, 2, 2))], True),
    "AlphaDropout eval": (lambda nn: nn.AlphaDropout(0.4), [X], True),
    "Flatten": (lambda nn: nn.Flatten(), [X], False),
    "Unflatten": (lambda nn: nn.Unflatten(2, [5, 1]), [X], False),
    "Bilinear": (lambda nn: nn.Bilinear(4, 5, 3),
                 [("f", (6, 4)), ("f", (6, 5))], False),
    "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=2), [X, X],
                         False),
    "PairwiseDistance": (lambda nn: nn.PairwiseDistance(p=3.0), [X, X],
                         False),
    "LayerNorm": (lambda nn: nn.LayerNorm([4, 5]), [X], False),
    "LayerNorm no bias": (lambda nn: nn.LayerNorm(5, bias_attr=False), [X],
                          False),
    "RMSNorm": (lambda nn: nn.RMSNorm(5), [X], False),
    "GroupNorm": (lambda nn: nn.GroupNorm(2, 4), [("f", (2, 4, 3, 3))],
                  False),
    "InstanceNorm1D": (lambda nn: nn.InstanceNorm1D(4), [("f", (2, 4, 6))],
                       False),
    "InstanceNorm2D": (lambda nn: nn.InstanceNorm2D(4),
                       [("f", (2, 4, 3, 3))], False),
    "InstanceNorm3D": (lambda nn: nn.InstanceNorm3D(4),
                       [("f", (2, 4, 2, 3, 2))], False),
    "LocalResponseNorm": (lambda nn: nn.LocalResponseNorm(3),
                          [("f", (2, 5, 3, 3))], False),
    "CrossEntropyLoss soft": (lambda nn: nn.CrossEntropyLoss(
        soft_label=True, label_smoothing=0.1), [("f", (6, 7)), ("p", (6, 7))],
        False),
    "CrossEntropyLoss weight": (lambda nn: nn.CrossEntropyLoss(
        weight=_class_weights(nn), ignore_index=2),
        [("f", (6, 7)), ("i7", (6,))], False),
    "MSELoss": (lambda nn: nn.MSELoss(), [X, X], False),
    "L1Loss": (lambda nn: nn.L1Loss("none"), [X, X], False),
    "SmoothL1Loss": (lambda nn: nn.SmoothL1Loss(delta=0.3), [X, X], False),
    "NLLLoss": (lambda nn: nn.NLLLoss(ignore_index=1),
                [("f", (6, 7)), ("i7", (6,))], False),
    "BCELoss": (lambda nn: nn.BCELoss(), [("p", (4, 5)), ("b", (4, 5))],
                False),
    "BCEWithLogitsLoss": (lambda nn: nn.BCEWithLogitsLoss(reduction="sum"),
                          [("f", (4, 5)), ("b", (4, 5))], False),
    "KLDivLoss": (lambda nn: nn.KLDivLoss("sum"),
                  [("f", (4, 5)), ("p", (4, 5))], False),
    "HingeEmbeddingLoss": (lambda nn: nn.HingeEmbeddingLoss(0.5),
                           [("f", (4, 5)), ("pm", (4, 5))], False),
    "MarginRankingLoss": (lambda nn: nn.MarginRankingLoss(0.2),
                          [("f", (8,)), ("f", (8,)), ("pm", (8,))], False),
    "CosineEmbeddingLoss": (lambda nn: nn.CosineEmbeddingLoss(),
                            [("f", (6, 5)), ("f", (6, 5)), ("pm", (6,))],
                            False),
    "TripletMarginLoss": (lambda nn: nn.TripletMarginLoss(margin=0.5),
                          [("f", (6, 5))] * 3, False),
    "Sequential": (lambda nn: nn.Sequential(nn.Linear(5, 6), nn.ReLU(),
                                            nn.Linear(6, 3)), [X], False),
}


def _class_weights(nn):
    w = np.linspace(0.5, 1.5, 7).astype(np.float32)
    return torch.from_numpy(w) if nn is pnn else paddle.to_tensor(w)


def _pair_layers(make, seed=5):
    """The reference's layer and the port's, with the same numpy
    parameters (a Linear's transposed by `convert`)."""
    paddle.seed(0)
    jl, tl = make(jnn), make(pnn)
    rng = np.random.default_rng(seed)
    named = {}
    for name, p in jl.named_parameters():
        a = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        p._data = jnp.asarray(a)
        named[name] = a
    tl.load_state_dict(convert.state_dict_from_jax(named, model=tl))
    return jl, tl


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(name):
    make, specs, eval_mode = LAYERS[name]
    jl, tl = _pair_layers(make)
    assert list(tl.state_dict()) == list(jl.state_dict())
    if eval_mode:
        jl.eval()
        tl.eval()
    arrays = _arrays(specs, seed=len(name))
    jins = [_to_jax(a, k) for a, (k, _) in zip(arrays, specs)]
    tins = [_to_torch(a, k) for a, (k, _) in zip(arrays, specs)]
    _check(jl(*jins), tl(*tins), jins, tins, specs,
           jparams=list(jl.named_parameters()),
           tparams=dict(tl.named_parameters()),
           transpose=convert.linear_weights(tl))


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

def _containers(nn):
    from collections import OrderedDict

    seq = nn.Sequential(OrderedDict([("fc", nn.Linear(3, 4)),
                                     ("act", nn.ReLU()),
                                     ("norm", nn.LayerNorm(4))]))
    lst = nn.LayerList([nn.Linear(2, 2), nn.RMSNorm(2)])
    lst.append(nn.Embedding(5, 2))
    lst.insert(1, nn.PReLU())
    dct = nn.LayerDict({"a": nn.Linear(2, 3), "b": nn.GroupNorm(1, 2)})
    dct["c"] = nn.Bilinear(2, 2, 1)
    plist = nn.ParameterList([
        nn.Linear(1, 2).weight, nn.Linear(2, 1).bias])
    return {"Sequential": seq, "LayerList": lst, "LayerDict": dct,
            "ParameterList": plist}


@pytest.mark.parametrize("kind", ["Sequential", "LayerList", "LayerDict",
                                  "ParameterList"])
def test_container_state_dict_keys_are_the_reference(kind):
    paddle.seed(0)
    j, t = _containers(jnn)[kind], _containers(pnn)[kind]
    assert list(t.state_dict()) == list(j.state_dict())
    assert len(t) == len(j)
    for include_self in (False, True):
        assert [type(x).__name__ for x in t.sublayers(include_self)] == \
            [type(x).__name__ for x in j.sublayers(include_self)]
    if kind == "LayerList":
        assert [type(x).__name__ for x in t] == [type(x).__name__
                                                 for x in j]
        assert type(t[-1]).__name__ == "Embedding"
    if kind == "LayerDict":
        assert list(t.keys()) == list(j.keys()) and "c" in t
        assert type(t.pop("a")).__name__ == "Linear" and len(t) == 2


# ---------------------------------------------------------------------------
# ParamAttr through the optimizer
# ---------------------------------------------------------------------------

W0 = np.random.default_rng(11).standard_normal((6, 4)).astype(np.float32)
B0 = np.random.default_rng(12).standard_normal(4).astype(np.float32)

# name -> (ParamAttr keywords for the weight, optimizer, use_multi_tensor)
ATTRS = {
    "initializer": ({}, "adam", True),
    "learning_rate fused": ({"learning_rate": 0.25}, "adam", True),
    "learning_rate per-parameter": ({"learning_rate": 0.25}, "adam", False),
    "learning_rate momentum": ({"learning_rate": 0.25}, "momentum", None),
    "regularizer fused": ({"regularizer": "l2"}, "adam", True),
    "regularizer per-parameter": ({"regularizer": "l2"}, "adam", False),
    "regularizer momentum": ({"regularizer": "l2"}, "momentum", None),
    "regularizer adamw": ({"regularizer": "l2"}, "adamw", True),
    "need_clip fused": ({"need_clip": False}, "adam", True),
    "need_clip per-parameter": ({"need_clip": False}, "adam", False),
    "need_clip momentum": ({"need_clip": False}, "momentum", None),
    "trainable": ({"trainable": False}, "adam", True),
}


def _attr_pair(kw, opt, multi):
    """The reference's Linear(6, 4) and the port's, the weight through
    ``ParamAttr(initializer=Assign(W0), **kw)``, the bias through
    ``Assign(B0)``, each with its optimizer (weight decay 0.1 as an
    L2Decay, a global-norm clip of 0.05)."""
    sides = []
    for nn, init, reg, mk in (
            (jnn, jinit, JL2Decay, {
                "adam": popt.Adam, "adamw": popt.AdamW,
                "momentum": popt.Momentum}),
            (pnn, pinit, L2Decay, {"adam": Adam, "adamw": AdamW,
                                   "momentum": Momentum})):
        kw2 = dict(kw)
        if kw2.get("regularizer") == "l2":
            kw2["regularizer"] = reg(0.5)
        layer = nn.Linear(
            6, 4, weight_attr=nn.ParamAttr(initializer=init.Assign(W0),
                                           **kw2),
            bias_attr=nn.ParamAttr(initializer=init.Assign(B0)))
        clip = nn.ClipGradByGlobalNorm(0.05)
        extra = {} if multi is None else {"use_multi_tensor": multi}
        if opt == "momentum":
            o = mk[opt](learning_rate=0.1, parameters=layer.parameters(),
                        weight_decay=reg(0.1), grad_clip=clip)
        elif opt == "adamw":
            o = mk[opt](learning_rate=0.1, parameters=layer.parameters(),
                        weight_decay=0.1, grad_clip=clip, **extra)
        else:
            o = mk[opt](learning_rate=0.1, parameters=layer.parameters(),
                        weight_decay=reg(0.1), grad_clip=clip, **extra)
        sides.append((layer, o))
    return sides


@pytest.mark.parametrize("name", list(ATTRS))
def test_param_attr_through_three_optimizer_steps(name):
    kw, opt, multi = ATTRS[name]
    (jl, jo), (tl, to) = _attr_pair(kw, opt, multi)
    w = tl.weight
    assert w.requires_grad == kw.get("trainable", True)
    assert w.need_clip == kw.get("need_clip", True)
    assert w.optimize_attr == {"learning_rate": kw.get("learning_rate",
                                                       1.0)}
    assert (w.regularizer is not None) == ("regularizer" in kw)
    np.testing.assert_array_equal(w.detach().t().numpy(), W0)
    rng = np.random.default_rng(13)
    for _ in range(3):
        x = rng.standard_normal((5, 6)).astype(np.float32)
        y = rng.standard_normal((5, 4)).astype(np.float32)
        jloss = JF.mse_loss(jl(paddle.to_tensor(x)), paddle.to_tensor(y))
        jloss.backward()
        jo.step()
        jo.clear_grad()
        tloss = PF.mse_loss(tl(torch.from_numpy(x)), torch.from_numpy(y))
        tloss.backward()
        to.step()
        to.clear_grad()
        assert abs(float(jloss) - float(tloss)) < ATOL + RTOL * abs(
            float(jloss))
    _close(tl.weight.detach().t().numpy(), np.asarray(jl.weight._data),
           "weight")
    _close(tl.bias.detach().numpy(), np.asarray(jl.bias._data), "bias")
    if not kw.get("trainable", True):
        np.testing.assert_array_equal(tl.weight.detach().t().numpy(), W0)


def test_own_regularizer_takes_no_decay_on_either_adam_path():
    """A parameter with its own regularizer is not decayed: with a zero
    gradient, Adam (L2 0.1) leaves it where it is on the fused and the
    per-parameter paths, and moves the bias beside it."""
    for multi in (True, False):
        (_, _), (tl, to) = _attr_pair({"regularizer": "l2"}, "adam", multi)
        tl.weight.grad = torch.zeros_like(tl.weight)
        tl.bias.grad = torch.zeros_like(tl.bias)
        to.step()
        np.testing.assert_array_equal(tl.weight.detach().t().numpy(), W0)
        assert not np.array_equal(tl.bias.detach().numpy(), B0)


# ---------------------------------------------------------------------------
# initializers by their contract
# ---------------------------------------------------------------------------

def _draw(init, shape, dtype="float32", seed=0):
    return init(shape, dtype, "cpu", torch.Generator().manual_seed(seed))


def test_exact_initializers_equal_the_reference():
    for shape, make in (
            ((3, 4), lambda m: m.Constant(0.25)),
            ((3, 4), lambda m: m.Assign(np.arange(12.0).reshape(3, 4))),
            ((6, 2, 3, 3), lambda m: m.Dirac()),
            ((4, 2, 3), lambda m: m.Dirac(groups=2)),
            ((2, 3, 4, 4), lambda m: m.Bilinear())):
        got = _draw(make(pinit), shape).numpy()
        np.testing.assert_array_equal(got, np.asarray(make(jinit)(shape)))
    assert _draw(pinit.Constant(1.5), (2,), "bfloat16").dtype == \
        torch.bfloat16


@pytest.mark.parametrize("shape", [(256, 384), (64, 32, 3, 3)])
def test_random_initializers_by_their_contract(shape):
    fan_in, fan_out = (shape[1] * int(np.prod(shape[2:])),
                       shape[0] * int(np.prod(shape[2:])))
    n = int(np.prod(shape))
    tol = 5.0 / np.sqrt(n)          # sample moments at this size
    cases = {
        "Normal": (pinit.Normal(0.3, 2.0), 0.3, 2.0, None),
        "TruncatedNormal": (pinit.TruncatedNormal(0.1, 0.5), 0.1,
                            0.5 * 0.8796, (0.1 - 1.0, 0.1 + 1.0)),
        "Uniform": (pinit.Uniform(-0.2, 0.6), 0.2, 0.8 / np.sqrt(12),
                    (-0.2, 0.6)),
        "XavierUniform": (pinit.XavierUniform(), 0.0,
                          np.sqrt(2.0 / (fan_in + fan_out)),
                          (-np.sqrt(6.0 / (fan_in + fan_out)),
                           np.sqrt(6.0 / (fan_in + fan_out)))),
        "XavierNormal": (pinit.XavierNormal(gain=2.0), 0.0,
                         2.0 * np.sqrt(2.0 / (fan_in + fan_out)), None),
        "KaimingUniform": (pinit.KaimingUniform(), 0.0,
                           np.sqrt(2.0 / fan_in),
                           (-np.sqrt(6.0 / fan_in), np.sqrt(6.0 / fan_in))),
        "KaimingNormal": (pinit.KaimingNormal(negative_slope=0.5), 0.0,
                          np.sqrt(2.0 / 1.25) / np.sqrt(fan_in), None),
    }
    for name, (init, mean, std, bounds) in cases.items():
        t = _draw(init, shape).double()
        assert tuple(t.shape) == shape
        assert abs(float(t.mean()) - mean) < tol * std + 1e-12, name
        assert abs(float(t.std()) / std - 1) < tol, name
        if bounds is not None:
            assert float(t.min()) >= bounds[0] - 1e-6, name
            assert float(t.max()) <= bounds[1] + 1e-6, name
        assert torch.equal(_draw(init, shape), _draw(init, shape)), name
        assert not torch.equal(_draw(init, shape),
                               _draw(init, shape, seed=1)), name
        # the reference's draw has the same contract
        ref = np.asarray(_reference_twin(name)(shape), np.float64)
        assert abs(ref.std() / std - 1) < tol, name


def _reference_twin(name):
    return {"Normal": jinit.Normal(0.3, 2.0),
            "TruncatedNormal": jinit.TruncatedNormal(0.1, 0.5),
            "Uniform": jinit.Uniform(-0.2, 0.6),
            "XavierUniform": jinit.XavierUniform(),
            "XavierNormal": jinit.XavierNormal(gain=2.0),
            "KaimingUniform": jinit.KaimingUniform(),
            "KaimingNormal": jinit.KaimingNormal(negative_slope=0.5)}[name]


def test_orthogonal_and_gain():
    for shape in ((8, 5), (3, 4, 6)):
        w = _draw(pinit.Orthogonal(gain=2.0), shape).double()
        m = w.reshape(-1, shape[-1])
        gram = m.t() @ m if m.shape[0] >= m.shape[1] else m @ m.t()
        torch.testing.assert_close(gram, 4.0 * torch.eye(gram.shape[0],
                                                         dtype=gram.dtype),
                                   rtol=0, atol=1e-5)
        ref = np.asarray(jinit.Orthogonal(gain=2.0)(shape), np.float64)
        rm = ref.reshape(-1, shape[-1])
        rg = rm.T @ rm if rm.shape[0] >= rm.shape[1] else rm @ rm.T
        np.testing.assert_allclose(rg, 4.0 * np.eye(rg.shape[0]), atol=1e-5)
    for nl, p in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("linear", None)):
        assert pinit.calculate_gain(nl, p) == jinit.calculate_gain(nl, p)


def test_global_initializer_and_layer_defaults():
    lin = pnn.Linear(30, 20)
    limit = np.sqrt(6.0 / 50)
    assert lin.weight.abs().max() <= limit and not lin.bias.any()
    pinit.set_global_initializer(pinit.Constant(0.5), pinit.Constant(-1.0))
    try:
        g = pnn.Linear(3, 2)
        assert g.weight.eq(0.5).all() and g.bias.eq(-1.0).all()
        # an attr's own initializer wins over the global one
        own = pnn.Linear(3, 2, weight_attr=pinit.Constant(2.0))
        assert own.weight.eq(2.0).all()
        assert pnn.LayerNorm(4).weight.eq(0.5).all()
    finally:
        pinit.set_global_initializer(None)
    assert pinit.get_global_initializer() is None
    named = pnn.Linear(3, 2, weight_attr="w", bias_attr=False)
    assert named.weight.shape == (2, 3) and named.bias is None
    k = pnn.Linear(3, 2, weight_attr=pinit.KaimingUniform())
    # drawn in the reference's [in, out] layout: fan in = out features
    assert k.weight.abs().max() <= np.sqrt(6.0 / 2)


# ---------------------------------------------------------------------------
# dropout by its contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_rate_scaling_and_determinism(mode):
    x = torch.ones(200, 500)
    p = 0.3
    out = PF.dropout(x, p, mode=mode,
                     generator=torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], scale))
    again = PF.dropout(x, p, mode=mode,
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    other = PF.dropout(x, p, mode=mode,
                       generator=torch.Generator().manual_seed(1))
    assert not torch.equal(out, other)
    # outside training both modes pass x through, as the reference's
    jx = paddle.to_tensor(np.ones((4, 5), np.float32))
    want = np.asarray(JF.dropout(jx, p, training=False, mode=mode)._data)
    got = PF.dropout(torch.ones(4, 5), p, training=False, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    # the layer draws from its own generator in training only
    layer = pnn.Dropout(p, mode=mode,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(layer(x), out)
    layer.eval()
    assert torch.equal(layer(x), x)


def test_random_activations_by_their_contract():
    """``rrelu`` in training draws one slope a negative element from
    [lower, upper); ``gumbel_softmax`` gives distributions (one-hot with
    ``hard``, the soft gradient through it); both repeat under one
    generator."""
    x = torch.randn(64, 128)
    out = PF.rrelu(x, 0.1, 0.3, training=True,
                   generator=torch.Generator().manual_seed(0))
    neg = x < 0
    slopes = out[neg] / x[neg]
    assert float(slopes.min()) >= 0.1 and float(slopes.max()) < 0.3
    assert torch.equal(out[~neg], x[~neg])
    assert float(slopes.std()) > 0.03
    assert torch.equal(out, PF.rrelu(
        x, 0.1, 0.3, training=True,
        generator=torch.Generator().manual_seed(0)))
    logits = torch.randn(16, 10, requires_grad=True)
    soft = PF.gumbel_softmax(logits, 0.5,
                             generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(soft.sum(-1), torch.ones(16))
    hard = PF.gumbel_softmax(logits, 0.5, hard=True,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(hard.argmax(-1), soft.argmax(-1))
    assert torch.equal(hard.detach(), torch.nn.functional.one_hot(
        soft.argmax(-1), 10).float())
    (hard * torch.randn(16, 10)).sum().backward()
    assert logits.grad is not None and logits.grad.abs().sum() > 0


def test_dropout_axis_and_2d_drop_whole_slices():
    x = torch.ones(64, 32, 3, 3)
    out = PF.dropout2d(x, 0.5, generator=torch.Generator().manual_seed(0))
    per_map = out.reshape(64, 32, 9)
    assert ((per_map == 0).all(-1) | (per_map == 2.0).all(-1)).all()
    assert 0.4 < float((per_map[..., 0] == 0).float().mean()) < 0.6
    out = PF.dropout(x, 0.5, axis=1,
                     generator=torch.Generator().manual_seed(0))
    assert ((out == 0).all(0).all(-1).all(-1)
            | (out == 2.0).all(0).all(-1).all(-1)).all()
    a = PF.alpha_dropout(torch.randn(400, 500), 0.2,
                         generator=torch.Generator().manual_seed(0))
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1) < 0.02


# ---------------------------------------------------------------------------
# the token-chunked fused CE and FLAGS_fused_ce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_chunks", [1, 4])
def test_token_chunked_ce_matches_the_vocab_tiled_route(n_chunks):
    rng = np.random.default_rng(3)
    h = rng.standard_normal((37, 16)).astype(np.float32)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    y = rng.integers(0, 50, 37)
    y[::6] = -100
    grads = []
    for tiled in (True, False):
        th = torch.tensor(h, requires_grad=True)
        tw = torch.tensor(w, requires_grad=True)
        loss = PF.fused_linear_cross_entropy(
            th, tw, torch.from_numpy(y), vocab_tiled=tiled,
            n_chunks=n_chunks)
        loss.backward()
        grads.append((float(loss), th.grad, tw.grad))
    assert abs(grads[0][0] - grads[1][0]) < 1e-5
    for a, b in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_flag_fused_ce_off_takes_the_token_chunked_route(monkeypatch):
    from paddle_tpu_torch.nn.functional import loss as loss_mod

    calls = []
    orig = loss_mod._TokenChunkedCE.apply

    def counting(*a):
        calls.append(a[-1])
        return orig(*a)

    monkeypatch.setattr(loss_mod._TokenChunkedCE, "apply", counting)
    h, w = torch.randn(9, 8), torch.randn(11, 8)
    y = torch.randint(0, 11, (9,))
    on = PF.fused_linear_cross_entropy(h, w, y)
    assert calls == []
    set_flags({"FLAGS_fused_ce": False, "FLAGS_fused_ce_chunks": 3})
    try:
        off = PF.fused_linear_cross_entropy(h, w, y)
    finally:
        set_flags({"FLAGS_fused_ce": True, "FLAGS_fused_ce_chunks": 4})
    assert calls == [3]
    assert abs(float(on) - float(off)) < 1e-5
