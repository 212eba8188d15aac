"""Port of theoremsearch_tpu.core (see the package docstring)."""
