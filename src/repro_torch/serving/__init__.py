"""Serving runtime of the port: KV cache bridge, host tier, engine."""
