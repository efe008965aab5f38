"""Hand-written CUDA kernels of the port and their wrappers.

Counterpart of ``paddle_tpu/ops/pallas``: every Pallas kernel of the
reference becomes a kernel here, built from ``paddle_tpu_torch/csrc`` by
`_build` at first use; so do the reference's XLA-fused optimizer step
(``multi_tensor``) and weight-only linear (``weight_only``).
"""
