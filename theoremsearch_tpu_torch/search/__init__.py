"""Port of theoremsearch_tpu.search (see the package docstring)."""
