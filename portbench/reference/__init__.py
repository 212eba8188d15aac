"""The plain reference: float32 towers with TF32 off, their int8 form for
the control, and exact top-k in blocks. Plain PyTorch and NumPy; imports
nothing of the port, of its JAX twin, or of jax."""
