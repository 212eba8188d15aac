"""Port of theoremsearch_tpu.serve (see the package docstring)."""

from .app import SearchService
from .latex_display import clean_latex_for_display

__all__ = ["clean_latex_for_display", "SearchService"]
