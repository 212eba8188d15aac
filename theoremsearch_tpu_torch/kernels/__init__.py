"""Port of theoremsearch_tpu.kernels (see the package docstring)."""
