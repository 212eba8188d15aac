"""Port of theoremsearch_tpu.encoder (see the package docstring)."""
