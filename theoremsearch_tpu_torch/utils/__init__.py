"""Port of theoremsearch_tpu.utils (see the package docstring)."""
