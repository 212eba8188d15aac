"""Port of theoremsearch_tpu.search (see the package docstring)."""

from .delta import DeltaBuffer
from .engine import SearchEngine
from .filters import SearchFilters, compile_filter_mask, infer_type, parse_paper_filter
from .metadata import CorpusMetadata

__all__ = [
    "CorpusMetadata",
    "SearchFilters",
    "compile_filter_mask",
    "infer_type",
    "parse_paper_filter",
    "SearchEngine",
    "DeltaBuffer",
]
