"""Rank trained semseg probes by validation metrics.

Counterpart of contrib/interactive_interp/semseg/validation.py (reference
main :26-167): evaluate every probe in a checkpoint grid on a labeled
validation split — loss, accuracy, mean IoU — and write a CSV sorted by mIoU
so the best (lr, wd) setting is row one. Host numpy, as in the JAX package.
"""

import csv
import dataclasses
import json
import logging
import pathlib

import numpy as np

from ... import helpers
from ...data import OrderedConfig, OrderedDataLoader

from . import training

logger = logging.getLogger("semseg.validation")


@dataclasses.dataclass(frozen=True)
class Config:
    probe_ckpt: pathlib.Path = pathlib.Path("./checkpoints/semseg")
    acts: OrderedConfig = dataclasses.field(default_factory=OrderedConfig)
    """Labeled validation shards."""
    n_classes: int = 151
    dump_to: pathlib.Path = pathlib.Path("./results")


def worker_fn(cfg: Config) -> list[dict]:
    params = training.load(cfg.probe_ckpt)
    w = np.asarray(params["w"])  # (M, D, C)
    b = np.asarray(params["b"])  # (M, C)
    n_probes = w.shape[0]
    cfgs_meta = []
    cfgs_fpath = pathlib.Path(cfg.probe_ckpt) / "cfgs.json"
    if cfgs_fpath.exists():
        cfgs_meta = json.loads(cfgs_fpath.read_text())

    n_correct = np.zeros(n_probes, np.int64)
    n_total = 0
    loss_sum = np.zeros(n_probes, np.float64)
    conf = np.zeros((n_probes, cfg.n_classes, cfg.n_classes), np.int64)

    dl = OrderedDataLoader(cfg.acts)
    try:
        for batch in helpers.progress(dl, desc="validate"):
            assert "token_labels" in batch, (
                f"{cfg.acts.shards} has no labels.bin."
            )
            acts = np.asarray(batch["act"], np.float32)
            labels = batch["token_labels"].astype(np.int64)
            logits = np.einsum("bd,mdc->mbc", acts, w) + b[:, None, :]
            logits -= logits.max(axis=-1, keepdims=True)
            logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
            loss_sum += -logp[:, np.arange(len(labels)), labels].sum(axis=1)
            preds = logits.argmax(axis=-1)  # (M, B)
            n_correct += (preds == labels[None]).sum(axis=1)
            n_total += len(labels)
            for mi in range(n_probes):
                np.add.at(conf[mi], (labels, preds[mi]), 1)
    finally:
        dl.shutdown()

    rows = []
    for mi in range(n_probes):
        inter = np.diag(conf[mi]).astype(np.float64)
        union = conf[mi].sum(0) + conf[mi].sum(1) - np.diag(conf[mi])
        present = union > 0
        miou = float((inter[present] / union[present]).mean()) if present.any() else float("nan")
        row = {
            "probe": mi,
            "val_loss": float(loss_sum[mi] / max(n_total, 1)),
            "accuracy": float(n_correct[mi] / max(n_total, 1)),
            "mean_iou": miou,
        }
        if mi < len(cfgs_meta):
            row["learning_rate"] = cfgs_meta[mi].get("learning_rate")
            row["weight_decay"] = cfgs_meta[mi].get("weight_decay")
        rows.append(row)
    rows.sort(key=lambda r: -(r["mean_iou"] if np.isfinite(r["mean_iou"]) else -1))

    fpath = pathlib.Path(cfg.dump_to) / "validation.csv"
    fpath.parent.mkdir(parents=True, exist_ok=True)
    with open(fpath, "w", newline="") as fd:
        writer = csv.DictWriter(fd, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    logger.info("Best probe: %s", rows[0])
    return rows


def cli(cfg: Config) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    worker_fn(cfg)
