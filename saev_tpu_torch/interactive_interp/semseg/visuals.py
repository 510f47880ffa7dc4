"""Propose latents for manual verification.

Counterpart of contrib/interactive_interp/semseg/visuals.py (reference
main :17-141): for each segmentation class, rank the SAE latents most
associated with it (F1 across activation thresholds, same statistic the
quantitative intervention uses) and dump the top candidates per class as
JSON, ready for a human to inspect in the feature browser. The statistic's
pass (`quantitative.latent_class_stats`) runs on the card unless `device` is
"cpu".
"""

import dataclasses
import json
import logging
import pathlib
import typing as tp

import numpy as np

from ... import nn
from ...data import OrderedConfig
from .. import device_of
from . import quantitative

logger = logging.getLogger("semseg.visuals")


@dataclasses.dataclass(frozen=True)
class Config:
    sae_ckpt: pathlib.Path = pathlib.Path("./checkpoint/sae.pt")
    acts: OrderedConfig = dataclasses.field(default_factory=OrderedConfig)
    """Labeled shards."""
    n_classes: int = 151
    top_k: int = 5
    """Candidate latents proposed per class."""
    dump_to: pathlib.Path = pathlib.Path("./results")
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the statistic's pass runs: the card unless "cpu" is asked for."""


def worker_fn(cfg: Config) -> dict[str, list[dict]]:
    sae_cfg, params, state = nn.load(cfg.sae_ckpt, device=device_of(cfg.device))
    f1, top_values = quantitative.latent_class_stats(
        sae_cfg, params, state, cfg.acts, n_classes=cfg.n_classes
    )
    best_f1 = f1.max(axis=1)  # (C, S), best over thresholds

    proposals: dict[str, list[dict]] = {}
    for c in range(1, cfg.n_classes):
        if not np.any(best_f1[c] > 0):
            continue
        order = np.argsort(-best_f1[c])[: cfg.top_k]
        proposals[str(c)] = [
            {
                "latent": int(lat),
                "f1": float(best_f1[c, lat]),
                "max_value": float(top_values[lat]),
            }
            for lat in order
            if best_f1[c, lat] > 0
        ]

    fpath = pathlib.Path(cfg.dump_to) / "proposed_latents.json"
    fpath.parent.mkdir(parents=True, exist_ok=True)
    fpath.write_text(json.dumps(proposals, indent=2))
    logger.info("Proposed latents for %d classes -> %s", len(proposals), fpath)
    return proposals


def cli(cfg: Config) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    worker_fn(cfg)
