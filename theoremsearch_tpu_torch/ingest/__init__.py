"""Port of theoremsearch_tpu.ingest: the catalog alone. The rest of the
reference's ingest package (arXiv client, S3 locator, LaTeX extraction,
Stacks) is device-free and stays with the JAX package's CLI."""

from .catalog import Catalog

__all__ = ["Catalog"]
