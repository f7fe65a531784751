"""Training data: the reference's token pipeline (a copy; no JAX)."""
