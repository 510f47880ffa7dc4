"""Training."""
