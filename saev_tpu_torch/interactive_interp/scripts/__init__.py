"""Figure assets of the interactive-interpretability study."""
