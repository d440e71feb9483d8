"""The plain reference: the port's semantics in float64 PyTorch and NumPy,
importing nothing of the port or of JAX."""
