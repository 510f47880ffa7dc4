"""Runnable examples of the port (counterparts of the repo's `examples/`)."""
