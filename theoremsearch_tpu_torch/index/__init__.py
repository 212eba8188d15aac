"""Port of theoremsearch_tpu.index (see the package docstring)."""

from .builder import IndexBuilder
from .flat import FlatIndex
from .quant import dequantize_int8, quantize_int8

__all__ = ["FlatIndex", "quantize_int8", "dequantize_int8", "IndexBuilder"]
