"""Port of theoremsearch_tpu.index (see the package docstring)."""
