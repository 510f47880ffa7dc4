"""FishVista trait-discovery benchmark: unified evaluation of prototype
methods (random / PCA / k-means / semi-NMF / SAE) on segmentation-labeled
activation shards (counterpart of contrib/trait_discovery/src/tdiscovery/
fishvista/), and the supervised skyline of linear probes (`supervised`, on
the semantic-segmentation trainer of interactive_interp)."""

from . import evaluation, supervised, utils  # noqa: F401
