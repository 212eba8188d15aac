"""Port of theoremsearch_tpu.utils (see the package docstring)."""

from .progress import progress
from .shapes import pow2_bucket
from .tracing import JsonlTracer, NullTracer, Tracer, get_tracer

__all__ = [
    "Tracer", "JsonlTracer", "NullTracer", "get_tracer", "progress",
    "pow2_bucket",
]
