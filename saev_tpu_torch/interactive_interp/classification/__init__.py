"""Linear probes on [CLS] activations for image classification.

Counterpart of contrib/interactive_interp/classification/ (reference
config.py Train + grid, training.py main/make_models/evaluate).
"""

from .training import Train, evaluate, grid, load_cls_features, train  # noqa: F401
