"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The module layout mirrors ``paddle_tpu/``: the counterpart of
``paddle_tpu/<path>.py`` lives at ``paddle_tpu_torch/<path>.py``. This
package imports ``torch`` and numpy only, never ``jax`` and never
``paddle_tpu``.

Ported so far: the serving path. ``serving.ServingEngine`` drives
``jit.decode_step`` (chunked prefill and the decode burst) over
``models.gpt`` and the paged KV cache of ``inference.kv_cache``. The two
paged-attention kernels it runs are hand-written CUDA in
``csrc/paged_attention.cu``, bound in ``ops.kernels.paged_attention``.

Entry points take ``device=``: the default is the CUDA card, and a
machine without one raises. ``device="cpu"`` runs the kernels' plain
PyTorch versions, which is how the tests run.
"""
