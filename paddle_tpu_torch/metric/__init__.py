"""Metrics: the port of paddle_tpu/metric (``Metric``, ``Accuracy``,
``Precision``, ``Recall``, ``Auc`` and ``accuracy``).

The arithmetic runs on the host in numpy, as in the reference: `_to_np`
reads a tensor back (a host sync for one on the card, where the
reference syncs too), and the counts accumulate in Python numbers.
``compute`` returns a CPU tensor; `accuracy` returns a 0-d float32 CPU
tensor.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy; a ``[b, 1]`` label is taken as ``[b]``."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = [name] if name else [f"acc_top{k}" for k in self.topk]
        if len(self._name) == 1 and len(self.topk) == 1:
            self._name = [name or "acc"]
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _to_np(pred)
        label_np = _to_np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        top = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = top == label_np[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _to_np(correct)
        for i, k in enumerate(self.topk):
            self.total[i] += float(c[..., :k].sum())
        self.count += c.shape[0]
        return self.total[0] / max(self.count, 1)

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / max(self.count, 1) for t in self.total]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision of predictions thresholded at 0.5."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_to_np(preds) > 0.5).astype(np.int32).reshape(-1)
        y = _to_np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fp += int(((p == 1) & (y == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of predictions thresholded at 0.5."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_to_np(preds) > 0.5).astype(np.int32).reshape(-1)
        y = _to_np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (y == 1)).sum())
        self.fn += int(((p == 0) & (y == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` buckets of the positive class's
    score (the last column of a ``[b, 2]`` input): the trapezoid over the
    thresholds, descending, anchored at (0, 0)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _to_np(preds)
        if p.ndim == 2:
            p = p[:, -1]
        y = _to_np(labels).reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds - 1)
        pos = y.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp = np.concatenate([[0.0], np.cumsum(self._stat_pos[::-1])])
        fp = np.concatenate([[0.0], np.cumsum(self._stat_neg[::-1])])
        tpr, fpr = tp / tot_pos, fp / tot_neg
        # the trapezoid rule over (fpr, tpr)
        return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1])
                            / 2.0))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the top ``k`` predictions,
    a 0-d float32 tensor."""
    pred = _to_np(input)
    y = _to_np(label).reshape(-1)
    top = np.argsort(-pred, axis=-1)[:, :k]
    c = (top == y[:, None]).any(axis=1)
    return torch.tensor(c.mean(), dtype=torch.float32)
