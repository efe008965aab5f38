"""The port's metrics (`paddle_tpu_torch.metric`) against the JAX
package's (paddle_tpu/metric) on random numpy inputs from a seed, fed to
both over several batches; the port's also as torch tensors. The
arithmetic is numpy on the host in both, so every value must be equal
(``Auc``'s trapezoid to 1e-12: the port sums it without
``np.trapezoid``)."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one intra-op thread a process)

import paddle_tpu as paddle
import paddle_tpu.metric as jmetric
from paddle_tpu_torch import metric as pmetric


def _batches(kind, n=4, b=32, classes=7, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        if kind == "multiclass":
            yield (rng.standard_normal((b, classes)).astype(np.float32),
                   rng.integers(0, classes, (b, 1)).astype(np.int64))
        elif kind == "flat labels":
            yield (rng.standard_normal((b, classes)).astype(np.float32),
                   rng.integers(0, classes, (b,)).astype(np.int64))
        elif kind == "binary":
            yield (rng.random((b, 1)).astype(np.float32),
                   rng.integers(0, 2, (b, 1)).astype(np.int64))
        else:          # two-column scores for Auc
            p = rng.random((b,)).astype(np.float32)
            yield (np.stack([1 - p, p], axis=1),
                   rng.integers(0, 2, (b,)).astype(np.int64))


CASES = {
    "accuracy top1": (lambda m: m.Accuracy(), "multiclass"),
    "accuracy top1 flat labels": (lambda m: m.Accuracy(), "flat labels"),
    "accuracy top1,3": (lambda m: m.Accuracy(topk=(1, 3)), "multiclass"),
    "accuracy named": (lambda m: m.Accuracy(topk=2, name="a2"),
                       "multiclass"),
    "precision": (lambda m: m.Precision(), "binary"),
    "recall": (lambda m: m.Recall(), "binary"),
    "auc": (lambda m: m.Auc(), "two-column"),
    "auc 255 thresholds": (lambda m: m.Auc(num_thresholds=255),
                           "two-column"),
}


def _feed(mod, metric, kind, as_torch):
    out = []
    for pred, label in _batches(kind):
        if as_torch and mod is pmetric:
            pred, label = torch.from_numpy(pred), torch.from_numpy(label)
        elif mod is jmetric:
            pred, label = paddle.to_tensor(pred), paddle.to_tensor(label)
        if isinstance(metric, mod.Accuracy):
            step = metric.update(metric.compute(pred, label))
        else:
            step = metric.update(pred, label)
        out.append(np.hstack([step, metric.accumulate()]))
    return out


@pytest.mark.parametrize("as_torch", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_metric_matches_jax(case, as_torch):
    make, kind = CASES[case]
    want_m, got_m = make(jmetric), make(pmetric)
    assert got_m.name() == want_m.name()
    want = _feed(jmetric, want_m, kind, as_torch)
    got = _feed(pmetric, got_m, kind, as_torch)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=1e-12 if "auc" in case else 0)
    got_m.reset()
    want_m.reset()
    assert got_m.accumulate() == want_m.accumulate()


def test_accuracy_compute_squeezes_a_b_1_label():
    pred = np.array([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]], np.float32)
    acc = pmetric.Accuracy(topk=(1, 2))
    c = acc.compute(torch.from_numpy(pred), torch.tensor([[1], [2]]))
    assert c.shape == (2, 2) and c.dtype == torch.float32
    assert c.tolist() == [[1.0, 0.0], [0.0, 0.0]]
    acc.update(c)
    assert acc.accumulate() == [0.5, 0.5]


def test_accuracy_function_and_the_base_class():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((64, 10)).astype(np.float32)
    label = rng.integers(0, 10, (64, 1)).astype(np.int64)
    for k in (1, 5):
        want = float(np.asarray(jmetric.accuracy(
            paddle.to_tensor(pred), paddle.to_tensor(label), k=k)._data))
        got = pmetric.accuracy(torch.from_numpy(pred),
                               torch.from_numpy(label), k=k)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == want
    base = pmetric.Metric()
    assert base.compute(1, 2) == (1, 2)
    for method in (base.reset, base.accumulate, base.name):
        with pytest.raises(NotImplementedError):
            method()
    assert pmetric.Auc().accumulate() == 0.0
    assert pmetric.Precision().accumulate() == 0.0
