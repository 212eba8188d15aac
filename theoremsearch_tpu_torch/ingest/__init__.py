# Verbatim copy of theoremsearch_tpu/ingest/__init__.py (jax-free). The port imports nothing of the
# reference package, so it carries its own copy; keep the two in sync.
"""Host-side (CPU) ingest pipeline.

Capability-parity with the reference's acquisition/parsing stages
(SURVEY.md layers A and B) rebuilt around a local catalog instead of RDS:
arXiv metadata client, citation fallback chain, S3 bundle locator,
tarball extraction, main-tex finder, theorem extraction (LaTeX semantics
in a cursor-based scanner), Stacks Project ingest.
"""

from .latex.extract import extract_theorems
from .catalog import Catalog

__all__ = ["extract_theorems", "Catalog"]
