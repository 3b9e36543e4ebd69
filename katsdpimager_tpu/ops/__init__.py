"""Imaging operators (JAX/XLA)."""
