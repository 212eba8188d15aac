# Verbatim copy of theoremsearch_tpu/ingest/latex/__init__.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
from .extract import extract_theorems, Theorem

__all__ = ["extract_theorems", "Theorem"]
