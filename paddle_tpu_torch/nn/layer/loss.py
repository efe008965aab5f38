"""``CrossEntropyLoss``: the port of paddle_tpu/nn/layer/loss.py's, over
`nn.functional.cross_entropy` (hard labels: softmax cross entropy in
fp32, ``ignore_index``, the mean over the labels kept). Class weights,
soft labels, label smoothing, another ``axis`` and ``use_softmax=False``
raise until ROADMAP queue A3 ports them."""
from __future__ import annotations

import torch

from .. import functional as PF

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(torch.nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        refused = {"weight": weight is not None, "soft_label": soft_label,
                   "axis": axis != -1, "use_softmax": not use_softmax,
                   "label_smoothing": label_smoothing != 0.0}
        if any(refused.values()):
            what = ", ".join(k for k, v in refused.items() if v)
            raise NotImplementedError(
                f"CrossEntropyLoss({what}) is not ported yet: ROADMAP "
                "queue A3")
        self.ignore_index, self.reduction = ignore_index, reduction

    def forward(self, input, label):
        return PF.cross_entropy(input, label, ignore_index=self.ignore_index,
                                reduction=self.reduction)
