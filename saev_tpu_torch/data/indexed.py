"""Random-access view over activation shards (a copy of
saev_tpu/data/indexed.py, numpy on the host: it reads what extraction
wrote, for visuals and probing jobs, and needs no card).

Same on-disk protocol and `Example` dict contract as the reference's map-style
dataset (`src/saev/data/indexed.py:20-127`), different machinery:

- shard memmaps are opened once and cached per shard (the reference re-opens
  the memmap on every access, which costs a syscall + page-table churn per
  vector and is why its random-access path benchmarks ~0.1 batch/s);
- `take(indices)` gathers a whole batch of global indices in one vectorized
  pass, grouping by shard so each mmap is touched once per batch — the natural
  building block for visuals/probing jobs that sample scattered tokens.
"""

import dataclasses
import logging
import pathlib
import typing as tp

import numpy as np

from .. import guards
from . import shards

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Config:
    """Configuration for loading indexed activation data from disk.

    Attributes:
        shards: Directory with .bin shards and a metadata.json file.
        tokens: Token view: 'special' (the CLS token), 'content' (patch
            tokens), or 'all' (both).
        layer: Recorded layer to read; "all" interleaves every recorded layer.
        debug: Whether to log debug messages.
    """

    shards: pathlib.Path = pathlib.Path("$SAEV_SCRATCH/saev/shards/abcdefg")
    tokens: str = "content"
    layer: int | str = -2
    debug: bool = False


class Dataset:
    """Map-style dataset: one activation vector per index.

    `__getitem__` returns an `Example` dict; `take` returns stacked arrays for
    a batch of indices. Copy-on-write memmaps keep the OS page cache in charge
    of what stays resident.
    """

    class Example(tp.TypedDict, total=False):
        act: np.ndarray
        example_idx: int
        token_idx: int
        token_label: int

    def __init__(self, cfg: Config):
        root = pathlib.Path(cfg.shards)
        if not root.is_dir():
            raise RuntimeError(f"Activations are not saved at '{root}'.")
        self.cfg = cfg
        self._root = root

        self.md = shards.Metadata.load(root)
        info = shards.ShardInfo.load(root)
        info.validate(root)

        self.index_map = shards.IndexMap(self.md, cfg.tokens, cfg.layer)
        self._mmaps: dict[int, np.memmap] = {}

        self.labels_mmap = None
        labels_path = root / "labels.bin"
        if labels_path.exists():
            self.labels_mmap = np.memmap(
                labels_path,
                mode="r",
                dtype=np.uint8,
                shape=(self.md.n_examples, self.md.content_tokens_per_example),
            )

    @property
    def d_model(self) -> int:
        """Dimension of the underlying transformer's embedding space."""
        return self.md.d_model

    def __len__(self) -> int:
        return len(self.index_map)

    def _shard(self, shard_idx: int) -> np.memmap:
        """Copy-on-write mmap of one shard file, opened at most once."""
        mm = self._mmaps.get(shard_idx)
        if mm is None:
            fpath = self._root / f"acts{shard_idx:06}.bin"
            mm = np.memmap(fpath, mode="c", dtype=np.float32, shape=self.md.shard_shape)
            self._mmaps[shard_idx] = mm
        return mm

    def __getitem__(self, i: int) -> Example:
        coord = self.index_map.from_global(i)
        vec = self._shard(coord.shard_idx)[
            coord.example_idx_in_shard,
            coord.layer_idx_in_shard,
            coord.token_idx_in_shard,
        ]
        out = self.Example(
            act=np.array(vec, dtype=np.float32),
            example_idx=coord.example_idx,
            token_idx=coord.content_token_idx,
        )
        if self.labels_mmap is not None and coord.content_token_idx >= 0:
            out["token_label"] = int(
                self.labels_mmap[coord.example_idx, coord.content_token_idx]
            )
        return out

    def take(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        """Vectorized gather of many global indices.

        Returns `{act: (N, d_model) f32, example_idx: (N,), token_idx: (N,)
        [, token_label: (N,)]}` in the order given. Indices are grouped by
        shard so each shard's mmap is fancy-indexed once.
        """
        indices = np.asarray(indices, dtype=np.int64)
        guards.check("indices", indices, ndim=1, what="flat global indices")
        coords = [self.index_map.from_global(int(i)) for i in indices]

        n = len(indices)
        acts = np.empty((n, self.md.d_model), dtype=np.float32)
        by_shard: dict[int, list[int]] = {}
        for pos, c in enumerate(coords):
            by_shard.setdefault(c.shard_idx, []).append(pos)
        for shard_idx, positions in by_shard.items():
            mm = self._shard(shard_idx)
            ex = np.array([coords[p].example_idx_in_shard for p in positions])
            ly = np.array([coords[p].layer_idx_in_shard for p in positions])
            tk = np.array([coords[p].token_idx_in_shard for p in positions])
            acts[positions] = mm[ex, ly, tk]

        out = {
            "act": acts,
            "example_idx": np.array([c.example_idx for c in coords], dtype=np.int64),
            "token_idx": np.array(
                [c.content_token_idx for c in coords], dtype=np.int64
            ),
        }
        if self.labels_mmap is not None:
            # Per-row semantics matching __getitem__: content tokens get their
            # label, special/CLS tokens (content_token_idx == -1) get -1.
            labels = np.full(n, -1, dtype=np.int64)
            content = out["token_idx"] >= 0
            labels[content] = self.labels_mmap[
                out["example_idx"][content], out["token_idx"][content]
            ]
            out["token_label"] = labels
        return out
