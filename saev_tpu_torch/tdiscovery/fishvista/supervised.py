"""Supervised skyline for FishVista: linear patch-segmentation probes.

Counterpart of contrib/trait_discovery/src/tdiscovery/fishvista/supervised.py
(reference fishvista/supervised.py Config :40, make_models :99, train :115):
a grid of linear probes (learning rate x weight decay) trains on the labeled
train shards and reports per-class AP / mAP on the test shards — the upper
bound unsupervised prototype methods are compared against.

Reuses the stacked probe trainer of `interactive_interp.semseg.training`
(all probes in one AdamW step on a shared stream). The probes' training and
their test scores (an f32 product, TF32 off) run on the card unless `device`
is "cpu".
"""

import dataclasses
import json
import logging
import pathlib
import typing as tp

import numpy as np
import torch

from ...data import Metadata
from ...nn import modeling
from .. import device_of, metrics
from . import evaluation, utils

logger = logging.getLogger("fishvista.supervised")


@dataclasses.dataclass(frozen=True)
class Config:
    """Supervised-probe grid configuration (reference supervised.py:40-76):
    the JAX package's fields and defaults but for `device`."""

    train_acts: evaluation.OrderedConfig = dataclasses.field(
        default_factory=lambda: evaluation.OrderedConfig()
    )
    test_acts: evaluation.OrderedConfig = dataclasses.field(
        default_factory=lambda: evaluation.OrderedConfig()
    )
    learning_rates: tuple[float, ...] = (1e-4, 3e-4, 1e-3)
    weight_decays: tuple[float, ...] = (1e-4, 1e-3)
    n_train: int = 200_000
    """Training tokens per probe."""
    batch_size: int = 4096
    n_classes: int = utils.N_CLASSES
    dump_to: pathlib.Path = pathlib.Path("./results")
    seed: int = 42
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the probes train and score: the card unless "cpu" is asked for."""


class _ProbeScorer:
    """Adapts trained probe heads to the Scorer interface. All M probes score
    in ONE pass (class logits concatenated to M*C prototype columns), so the
    test shards stream once regardless of grid size."""

    def __init__(self, w: np.ndarray, b: np.ndarray, device: str = "cuda"):
        # w (M, D, C), b (M, C) -> flat (D, M*C) / (M*C,)
        m, d, c = w.shape
        self.m, self.c = m, c
        self.device = device_of(device)
        self.w = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (1, 0, 2)).reshape(d, m * c), np.float32)).to(self.device)
        self.b = torch.from_numpy(np.asarray(b, np.float32).reshape(m * c)).to(self.device)

    @property
    def n_prototypes(self) -> int:
        return self.w.shape[1]

    @torch.no_grad()
    def transform(self, batch: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(batch, np.float32)).to(self.device)
        with modeling._f32_products():
            return (x @ self.w + self.b).cpu().numpy()


def worker_fn(cfg: Config) -> dict:
    """Train the probe grid, evaluate each on the test split, report the best
    per-class AP across the grid (reference supervised.py:115-230)."""
    from ...interactive_interp.semseg import training as semseg_training

    md = Metadata.load(cfg.train_acts.shards)
    probe_cfgs = [
        semseg_training.Train(
            shards=cfg.train_acts.shards, layer=cfg.train_acts.layer,
            n_classes=cfg.n_classes, learning_rate=lr, weight_decay=wd,
            n_train=cfg.n_train, batch_size=cfg.batch_size, seed=cfg.seed,
            device=cfg.device,
        )
        for lr in cfg.learning_rates
        for wd in cfg.weight_decays
    ]
    params = semseg_training.train(probe_cfgs)
    w = np.asarray(params["w"])  # (M, d_model, n_classes)
    b = np.asarray(params["b"])  # (M, n_classes)

    # One ordered pass scores every probe (scores columns are M*C flat).
    scorer = _ProbeScorer(w, b, cfg.device)
    flat_scores, labels = evaluation.compute_patch_scores(
        cfg.test_acts, scorer, desc="probe-grid test"
    )
    onehot = np.zeros((len(labels), cfg.n_classes), dtype=np.float64)
    onehot[np.arange(len(labels)), np.clip(labels, 0, cfg.n_classes - 1)] = 1.0

    results = []
    for mi, pc in enumerate(probe_cfgs):
        scores = flat_scores[:, mi * cfg.n_classes : (mi + 1) * cfg.n_classes]
        ap = metrics.average_precision(scores.astype(np.float64), onehot)
        finite = ap[np.isfinite(ap)]
        results.append({
            "learning_rate": pc.learning_rate,
            "weight_decay": pc.weight_decay,
            "ap_per_class": [float(a) for a in ap],
            "mean_ap": float(finite.mean()) if len(finite) else float("nan"),
        })
        logger.info(
            "probe lr=%g wd=%g: mAP=%.4f", pc.learning_rate, pc.weight_decay,
            results[-1]["mean_ap"],
        )

    best = max(results, key=lambda r: (r["mean_ap"], ))
    out = {
        "method": "supervised-linear",
        "n_probes": len(probe_cfgs),
        "n_classes": cfg.n_classes,
        "d_model": md.d_model,
        "results": results,
        "best": best,
    }
    fpath = pathlib.Path(cfg.dump_to) / "fishvista_supervised.json"
    fpath.parent.mkdir(parents=True, exist_ok=True)
    fpath.write_text(json.dumps(out, indent=2))
    return out


def cli(cfg: Config) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    worker_fn(cfg)
