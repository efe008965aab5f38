"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The module layout mirrors ``paddle_tpu/``: the counterpart of
``paddle_tpu/<path>.py`` lives at ``paddle_tpu_torch/<path>.py``. This
package imports ``torch`` and numpy only, never ``jax`` and never
``paddle_tpu``.

Ported so far: the serving path (fp, int8 and int4 KV pages),
generation, ResNet training, checkpoint files, and single-card
pretraining through splash attention or,
with ``FLAGS_splash_attn`` off, the flash kernels. ``serving.ServingEngine``
drives ``jit.decode_step`` (chunked prefill and the decode burst) over
``models.gpt`` and the paged KV cache of ``inference.kv_cache``; its
paged-attention kernels (decode and chunk, over fp pools and over
quantized pools whose dequant they fuse) are hand-written CUDA in
``csrc/paged_attention.cu``. ``GPTForCausalLM.generate`` runs
``jit.GenerationEngine`` over the paged or the dense cache, as CUDA
graphs on the card; ``nn.quant.quantize_for_decode`` gives it int8 /
int4 weight-only Linears, whose product is the hand-written
``csrc/weight_only.cu``.
``jit.TrainStep`` drives
``models.gpt``'s ``loss`` (splash or flash attention and the vocab-tiled
fused cross entropy, forward and backward, in
``csrc/{splash,flash}_attention.cu`` and ``csrc/fused_cross_entropy.cu``),
``nn.ClipGradByGlobalNorm`` and ``optimizer.AdamW``. ``ops.kernels``
binds every kernel; `get_flags` / `set_flags` (``utils.flags``) read and
set the routing flags.

LLaMA training: ``models.llama`` (RMSNorm, RoPE, grouped-query dense
attention, SwiGLU) over the rest of ``nn`` (``ParamAttr``,
``initializer``, the activation, common, norm, container and loss
layers and functionals), trained by ``jit.TrainStep`` through the fused
cross entropy.

Vision training: ``vision.models`` (the ResNet family) over ``nn``'s
convolution, batch norm, pooling, Linear and cross-entropy layers,
trained by ``jit.TrainStep`` (``optimizer.Momentum``); these run as
cuDNN and aten ops, as the reference runs XLA ops. ``io.DevicePrefetcher``
(``TrainStep.prefetch``) stages host batches on the card on a side
stream. `save` / `load` (``framework.io``) read and write the
reference's ``paddle.save`` files; ``convert`` maps a model's and an
optimizer's state between the two packages.

BERT fine-tuning: ``models.bert`` (the reference's post-LN encoder;
its attention is the dense path of
``nn.functional.scaled_dot_product_attention`` with the padding mask and
attention dropout) under ``amp.decorate(level="O2")`` and
``jit.TrainStep``. The high-level API: ``Model`` (``hapi``: ``fit``,
``evaluate``, ``predict``, ``save``, ``load``) over ``io.DataLoader``,
``metric`` and ``vision`` (``LeNet``, synthetic ``MNIST``); `summary`
and `flops`.

Entry points take ``device=``: the default is the CUDA card, and a
machine without one raises. ``device="cpu"`` runs the kernels' plain
PyTorch versions, which is how the tests run.
"""

from . import metric
from .framework.io import load, save
from .hapi import Model, flops, summary
from .utils.flags import get_flags, set_flags

__all__ = ["Model", "flops", "get_flags", "load", "metric", "save",
           "set_flags", "summary"]
