"""Hand-written CUDA kernels of the port and their wrappers.

Counterpart of ``paddle_tpu/ops/pallas``: every Pallas kernel of the
reference becomes a kernel here, built from ``paddle_tpu_torch/csrc`` by
`_build` at first use.
"""
