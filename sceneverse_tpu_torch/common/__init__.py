"""Helpers shared across the port (its own copies of the JAX package's
``common/`` modules)."""
