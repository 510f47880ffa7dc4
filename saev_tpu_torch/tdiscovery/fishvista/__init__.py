"""FishVista trait-discovery benchmark: unified evaluation of prototype
methods (random / PCA / k-means / semi-NMF / SAE) on segmentation-labeled
activation shards (counterpart of contrib/trait_discovery/src/tdiscovery/
fishvista/ but its supervised skyline, which needs the semantic-segmentation
trainer of interactive_interp)."""

from . import evaluation, utils  # noqa: F401
