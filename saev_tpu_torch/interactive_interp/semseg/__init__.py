"""Semantic-segmentation linear probes over ViT activations and SAE latent
interventions on them (counterpart of contrib/interactive_interp/semseg)."""
