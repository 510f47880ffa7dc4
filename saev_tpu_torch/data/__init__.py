"""Activation shards on disk, the shuffled loader that feeds the train loop,
the ordered loader that feeds inference, random access to shard rows, and
extraction's datasets, model family registry and worker (counterparts of
saev_tpu/data's `shards`, `buffers`, `shuffled`, `ordered`, `indexed`,
`_native`, `datasets`, `transforms`, `models`, `fake_vit` and `extract`)."""

import dataclasses

from .indexed import Config as IndexedConfig
from .indexed import Dataset as IndexedDataset
from .ordered import Config as OrderedConfig
from .ordered import DataLoader as OrderedDataLoader
from .shards import Metadata, PixelAgg
from .shuffled import Config as ShuffledConfig
from .shuffled import DataLoader as ShuffledDataLoader

__all__ = [
    "IndexedConfig",
    "IndexedDataset",
    "Metadata",
    "OrderedConfig",
    "OrderedDataLoader",
    "PixelAgg",
    "ShuffledConfig",
    "ShuffledDataLoader",
    "make_ordered_config",
]


def _register_families():
    """Register every transformer family at import (saev_tpu/data/__init__.py:26-46,
    reference data/__init__.py:26-33): fake-clip, then clip, siglip, dinov2,
    pe-core and pe-spatial (`models.families`), dinov3 and bird-mae. None of
    them needs Pillow or pandas to import."""
    from ..models import bird_mae, dinov3, families  # noqa: F401
    from . import fake_vit  # noqa: F401


_register_families()


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
