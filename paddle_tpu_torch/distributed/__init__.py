"""Distributed: so far only the comm stack's int8 quantizer, which the
int8 paged KV pools store in."""
from .collective import dequantize_q8, quantize_symmetric_q8

__all__ = ["quantize_symmetric_q8", "dequantize_q8"]
