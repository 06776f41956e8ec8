"""Host utilities copied from the JAX package (no device code)."""
