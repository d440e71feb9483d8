"""Model assembly (re-exported from the jax-free reference module)."""
