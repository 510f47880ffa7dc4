"""Activation shards on disk, the shuffled loader that feeds the train loop
and the ordered loader that feeds inference (counterparts of saev_tpu/data's
`shards`, `buffers`, `shuffled`, `ordered` and `_native`, without its image
datasets and model families)."""

import dataclasses

from .ordered import Config as OrderedConfig
from .ordered import DataLoader as OrderedDataLoader
from .shards import Metadata
from .shuffled import Config as ShuffledConfig
from .shuffled import DataLoader as ShuffledDataLoader

__all__ = [
    "Metadata",
    "OrderedConfig",
    "OrderedDataLoader",
    "ShuffledConfig",
    "ShuffledDataLoader",
    "make_ordered_config",
]


def make_ordered_config(shuffled_cfg: ShuffledConfig, **overrides: object) -> OrderedConfig:
    """Create an `OrderedConfig` from a `ShuffledConfig`, with optional overrides.

    Defaults come from `shuffled_cfg` for fields present in `OrderedConfig`; `overrides`
    take precedence (saev_tpu/data/__init__.py:49-62, reference data/__init__.py:37-50).
    """
    params: dict[str, object] = {}
    for f in dataclasses.fields(OrderedConfig):
        if hasattr(shuffled_cfg, f.name):
            params[f.name] = getattr(shuffled_cfg, f.name)
    params.update(overrides)
    return OrderedConfig(**params)
