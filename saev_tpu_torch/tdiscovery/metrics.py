"""Trait-discovery evaluation: average precision, purity@k, best-latent probes
(counterpart of contrib/trait_discovery/src/tdiscovery/metrics.py; reference
worker_fn :62-273): pick the best (latent, w, b) per class by train probe
loss, score the validation split, and report per-class AP plus purity@k of
each latent's top activating patches. Host-only numpy.
"""

import dataclasses
import logging
import pathlib

import numpy as np
import scipy.sparse

from .. import disk, helpers
from ..data import Metadata

logger = logging.getLogger("td.metrics")


@dataclasses.dataclass(frozen=True)
class Config:
    """AP evaluation config (reference metrics.py:33-59)."""

    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    """Run directory."""
    train_shards: pathlib.Path = pathlib.Path("./shards/01234567")
    """Training shards directory."""
    test_shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Test shards directory."""
    max_k: int = 256
    """How many patches to record labels for (purity@k)."""
    debug: bool = False


def ap_from_sorted(labels_sorted: np.ndarray) -> np.ndarray:
    """Per-column AP from labels already sorted by descending score; NaN for
    columns with no positives."""
    n = labels_sorted.shape[0]
    tp = labels_sorted.cumsum(axis=0)
    ranks = np.arange(1, n + 1, dtype=np.float64)[:, None]
    precision = tp / ranks
    n_pos = labels_sorted.sum(axis=0)
    ap = (precision * labels_sorted).sum(axis=0) / np.maximum(n_pos, 1.0)
    ap = np.where(n_pos > 0, ap, np.nan)
    return ap.astype(np.float64)


def average_precision(scores_nc: np.ndarray, labels_onehot_nc: np.ndarray) -> np.ndarray:
    """Per-class AP from raw scores (standard area-under-PR; reference
    metrics.py:183-220). Returns (n_classes,), NaN for classes with no
    positives."""
    sort_idx = np.argsort(-scores_nc, axis=0)
    return ap_from_sorted(np.take_along_axis(labels_onehot_nc, sort_idx, axis=0))


def purity_at_k(top_labels_dk: np.ndarray, k: int) -> np.ndarray:
    """Fraction of the k top-activating patches sharing the modal label, per
    latent (reference metrics.py:155-170)."""
    assert k <= top_labels_dk.shape[1]
    labels = top_labels_dk[:, :k]
    purities = np.empty(labels.shape[0], dtype=np.float32)
    for i in range(labels.shape[0]):
        _, counts = np.unique(labels[i], return_counts=True)
        purities[i] = counts.max() / k
    return purities


def worker_fn(cfg: Config) -> dict[str, object]:
    """Evaluate the trained probes on the validation split
    (reference metrics.py:62-273). Returns and saves the metric dict."""
    run = disk.Run(cfg.run)
    train_art = run.inference / cfg.train_shards.name
    val_art = run.inference / cfg.test_shards.name

    with np.load(train_art / "probe1d_metrics.npz") as fd:
        train_loss_lc = fd["loss"]
        weights_lc = fd["weights"]
        biases_lc = fd["biases"]
    n_latents, n_classes = train_loss_lc.shape

    best_latent_idx_c = np.argmin(train_loss_lc, axis=0)
    class_idx_c = np.arange(n_classes)
    best_weights_c = weights_lc[best_latent_idx_c, class_idx_c]
    best_biases_c = biases_lc[best_latent_idx_c, class_idx_c]
    logger.info(
        "Best latents per class: %d classes, %d unique latents.",
        n_classes, np.unique(best_latent_idx_c).size,
    )

    val_md = Metadata.load(cfg.test_shards)
    val_acts = scipy.sparse.load_npz(val_art / "token_acts.npz").tocsr()
    val_n_samples, val_n_latents = val_acts.shape
    assert val_n_latents == n_latents

    val_labels = np.asarray(
        np.memmap(
            cfg.test_shards / "labels.bin", mode="r", dtype=np.uint8,
            shape=(val_md.n_examples, val_md.content_tokens_per_example),
        )
    ).reshape(-1)
    assert val_labels.size == val_n_samples
    assert int(val_labels.max()) < n_classes

    max_k = min(cfg.max_k, val_n_samples)
    topk = helpers.csr_topk(val_acts, k=max_k, axis=0)
    top_labels_dk = np.take(val_labels, topk.indices.T).astype(np.uint8)
    # Mask dead/rare latents: a latent with fewer than k nonzero activations
    # gets arbitrary zero-valued tokens in its "top" (csr_topk docstring) —
    # typically consecutive same-label patches — inflating purity to ~1.0.
    nnz_per_latent = np.asarray((val_acts > 0).sum(axis=0)).reshape(-1)

    purities = {}
    for k in (16, 64, 256):
        if k > max_k:
            continue
        alive = nnz_per_latent >= k
        if not alive.any():
            continue
        p = purity_at_k(top_labels_dk[alive], k)
        purities[f"purity@{k}"] = {
            "mean": float(p.mean()), "min": float(p.min()), "max": float(p.max()),
            "n_alive": int(alive.sum()),
        }
        logger.info("purity@%d: mean=%.4f (%d alive)", k, p.mean(), alive.sum())

    val_best = np.asarray(val_acts[:, best_latent_idx_c].todense())
    val_scores_nc = val_best * best_weights_c + best_biases_c
    labels_onehot = np.zeros((val_n_samples, n_classes), dtype=np.float32)
    labels_onehot[np.arange(val_n_samples), val_labels] = 1.0

    ap_c = average_precision(val_scores_nc, labels_onehot)
    preds = val_scores_nc > 0
    tp = (preds & (labels_onehot > 0)).sum(axis=0).astype(np.float64)
    fp = (preds & (labels_onehot == 0)).sum(axis=0).astype(np.float64)
    fn = ((~preds) & (labels_onehot > 0)).sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = tp / np.maximum(tp + fp, 1.0)
        recall = tp / np.maximum(tp + fn, 1.0)
        f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)

    results = {
        "mean_ap": float(np.nanmean(ap_c)),
        "ap_per_class": ap_c.tolist(),
        "precision_per_class": precision.tolist(),
        "recall_per_class": recall.tolist(),
        "f1_per_class": f1.tolist(),
        "best_latent_per_class": best_latent_idx_c.tolist(),
        **purities,
    }
    out_fpath = val_art / "trait_metrics.json"
    with open(out_fpath, "wb") as fd:
        helpers.jdump(results, fd, indent=2)

    # The analysis layer reads a per-(train, val) npz with the raw arrays
    # (reference metrics.py:262-271).
    np.savez(
        val_art / f"probe1d_metrics__train-{cfg.train_shards.name}.npz",
        ap=np.nan_to_num(ap_c, nan=0.0).astype(np.float32),
        precision=precision.astype(np.float32),
        recall=recall.astype(np.float32),
        f1=f1.astype(np.float32),
        top_labels=top_labels_dk,
        nnz_per_latent=nnz_per_latent.astype(np.int64),
        n_pos_per_class=labels_onehot.sum(axis=0).astype(np.int64),
    )
    logger.info("mAP=%.4f; wrote %s", results["mean_ap"], out_fpath)
    return results


def cli(cfg: Config, sweep: pathlib.Path | None = None) -> None:
    """Run AP evaluation; with --sweep, expand a sweep file of config dicts
    (reference probe1d_metrics sweeps)."""
    from .. import configs

    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    if sweep is None:
        worker_fn(cfg)
        return
    sweep_dcts = configs.load_sweep(sweep)
    if not sweep_dcts:
        # Never silently fall back to the bare CLI config.
        logger.error("No valid sweeps found in '%s'.", sweep)
        raise SystemExit(1)
    cfgs, errs = configs.load_cfgs(cfg, default=Config(), sweep_dcts=sweep_dcts)
    for err in errs:
        logger.warning("Error in config: %s", err)
    for i, c in enumerate(cfgs, start=1):
        logger.info("Running metrics config %d/%d.", i, len(cfgs))
        worker_fn(c)
