"""The SAE and its training objective."""
