"""Synthetic assets (re-exported from the jax-free reference module)."""
