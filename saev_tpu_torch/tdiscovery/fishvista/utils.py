"""Shared FishVista helpers (counterpart of contrib/trait_discovery/src/
tdiscovery/fishvista/utils.py).

Per-patch labels come from the shards' labels.bin, which the ordered loader
attaches as `batch["token_labels"]`.
"""

import dataclasses
import json
import pathlib

import numpy as np

# FishVista trait segmentation: background + 9 trait classes
# (reference fishvista/utils.py hardcodes 10).
N_CLASSES = 10


@dataclasses.dataclass(frozen=True)
class Result:
    """One method evaluation (reference utils.py:19-33)."""

    method: str
    n_prototypes: int
    best_prototype_per_class: list[int]
    train_ap_per_class: list[float]
    test_ap_per_class: list[float]
    mean_ap: float
    n_train_patches: int
    n_test_patches: int
    seed: int
    extra: dict = dataclasses.field(default_factory=dict)
    """Provenance for results analysis (reference results.py unnests an
    `extra` column: vit_family/vit_ckpt/layer/sae_ckpt/n_train)."""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump_json(self, fpath: pathlib.Path) -> None:
        fpath.parent.mkdir(parents=True, exist_ok=True)
        fpath.write_text(json.dumps(self.to_dict(), indent=2))

    def dump_csv(self, fpath: pathlib.Path) -> None:
        fpath.parent.mkdir(parents=True, exist_ok=True)
        lines = ["class,best_prototype,train_ap,test_ap"]
        for c, (idx, tr, te) in enumerate(
            zip(self.best_prototype_per_class, self.train_ap_per_class,
                self.test_ap_per_class)
        ):
            lines.append(f"{c},{idx},{tr},{te}")
        fpath.write_text("\n".join(lines) + "\n")


def make_keep_mask(n_total: int, n_keep: int, *, seed: int) -> np.ndarray:
    """Boolean mask keeping a seeded random subset of patches
    (reference utils/evaluation.py make_keep_mask)."""
    if n_keep < 0 or n_keep >= n_total:
        return np.ones(n_total, dtype=bool)
    rng = np.random.default_rng(seed)
    mask = np.zeros(n_total, dtype=bool)
    mask[rng.permutation(n_total)[:n_keep]] = True
    return mask
