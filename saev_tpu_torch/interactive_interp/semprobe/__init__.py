"""Semantic probing: score SAE latents as binary concept detectors over curated
image sets (counterpart of contrib/interactive_interp/semprobe)."""
