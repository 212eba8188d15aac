"""theoremsearch_tpu_torch: the PyTorch + CUDA port of theoremsearch_tpu.

Mirrors the reference package's layout and names, module by module. It
imports torch and never jax: the reference package stays the frozen
reference the port's tests hold it against. Each TPU (Pallas) kernel on
the ported path is a hand-written CUDA kernel under `csrc/`, built with
nvcc at first use (`kernels/_build.py`), with a plain PyTorch version in
the same module for CPU tensors.
"""
