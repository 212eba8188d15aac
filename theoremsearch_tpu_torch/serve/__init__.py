"""Port of theoremsearch_tpu.serve (see the package docstring)."""
