"""Activation shards on disk and the shuffled loader that feeds the train
loop (counterparts of saev_tpu/data's `shards`, `buffers`, `shuffled` and
`_native`, without its image datasets and model families)."""

from .shards import Metadata
from .shuffled import Config as ShuffledConfig
from .shuffled import DataLoader as ShuffledDataLoader

__all__ = ["Metadata", "ShuffledConfig", "ShuffledDataLoader"]
