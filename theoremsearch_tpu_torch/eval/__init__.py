"""Port of theoremsearch_tpu.eval (see the package docstring)."""
