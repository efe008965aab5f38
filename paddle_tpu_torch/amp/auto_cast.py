"""AMP decoration: the port of paddle_tpu/amp/auto_cast.py's ``decorate``.

``decorate(level="O2")`` casts the fp32 parameters of every module that is
not a LayerNorm or a batch norm (torch's or the port's) to the AMP dtype
(bf16 by default), in place
(the modules keep their Parameter objects), and turns on the optimizers'
``multi_precision`` fp32 masters. The port's `models.gpt.LayerNorm`
normalises in its fp32 weights' dtype and returns the bf16 activations'
dtype, as the reference's layer norm does.

``auto_cast`` level O1 (per-op white and black lists) is not ported yet:
it raises. Level O2 needs no per-op casting once ``decorate`` has cast
the model, so its context changes nothing.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..nn.layer.norm import _BatchNormBase

__all__ = ["auto_cast", "decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_KEEP_FP32 = (nn.LayerNorm, nn.modules.batchnorm._BatchNorm,
              _BatchNormBase)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    if enable and level == "O1":
        raise NotImplementedError(
            "auto_cast level O1 (per-op white/black lists) is not ported "
            "yet: ROADMAP queue A2; use decorate(level='O2')")
    yield


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """paddle.amp.decorate: at O2 cast the model's parameters (LayerNorm
    and BatchNorm excepted) to ``dtype`` and turn on master weights.
    Returns the models (and optimizers) as given: one or a list."""
    single_model = isinstance(models, nn.Module)
    model_list = [models] if single_model else list(models)
    if level == "O2":
        target = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        keep = _KEEP_FP32 + tuple(excluded_layers or ())
        for model in model_list:
            for module in model.modules():
                if isinstance(module, keep):
                    continue
                for p in module.parameters(recurse=False):
                    if p.dtype == torch.float32:
                        p.data = p.data.to(target)
    if optimizers is None:
        return models
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    for opt in opt_list:
        if master_weight is not False:
            opt._multi_precision = True
    return models, optimizers
