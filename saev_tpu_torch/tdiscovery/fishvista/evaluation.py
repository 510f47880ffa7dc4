"""Unified trait-discovery evaluation on FishVista-style labeled shards
(counterpart of contrib/trait_discovery/src/tdiscovery/fishvista/
evaluation.py): score every patch with a prototype method (random / pca /
kmeans / semi-nmf / sae), pick the best prototype per trait class by average
precision on the train split, and report that prototype's AP on the held-out
test split.

As in the JAX package, patch labels come from the shards' labels.bin through
the ordered loader's `token_labels`, and unfitted baselines are fitted from a
shuffled pass over the train shards (`n_fit` tokens) unless `baseline_run`
names a fitted checkpoint. The scorers' device work (the SAE forward, the
k-means distances, the semi-NMF encode) runs on the card unless
`device="cpu"`.
"""

import dataclasses
import logging
import pathlib
import typing as tp

import numpy as np

from ... import disk, helpers
from ...data import Metadata, OrderedConfig, OrderedDataLoader, ShuffledConfig, ShuffledDataLoader
from ...utils.scheduling import BatchLimiter
from .. import baselines, metrics, saes
from . import utils

logger = logging.getLogger("fishvista.evaluation")

Method = tp.Literal["random", "pca", "kmeans", "semi-nmf", "sae"]


@dataclasses.dataclass(frozen=True)
class Config:
    """Evaluation configuration (reference fishvista/evaluation.py:28-77):
    the JAX package's fields and defaults but for `device`."""

    method: Method = "random"
    """Which prototype method to evaluate."""
    n_prototypes: int = 1024 * 32
    """Number of prototypes/components (ignored for method='sae')."""
    sae_ckpt: str = ""
    """Pre-trained SAE checkpoint (method='sae' only)."""
    baseline_run: str = ""
    """Run dir with a fitted baseline checkpoint; empty fits in-pipeline."""
    train_acts: OrderedConfig = dataclasses.field(default_factory=OrderedConfig)
    """Train-split activations (ordered pass; shards must have labels.bin)."""
    test_acts: OrderedConfig = dataclasses.field(default_factory=OrderedConfig)
    """Test-split activations (ordered pass; shards must have labels.bin)."""
    n_fit: int = 1_000_000
    """Tokens used to fit unfitted baselines from the train shards."""
    n_train: int = -1
    """Patches used to pick best prototypes (<0 = all)."""
    n_classes: int = utils.N_CLASSES
    """Number of segmentation classes incl. background."""
    dump_to: pathlib.Path = pathlib.Path("./results")
    """Where to save results."""
    output_format: tp.Literal["json", "csv", "both"] = "json"
    seed: int = 42
    ap_chunk: int = 512
    """Prototype columns scored per AP chunk (bounds the argsort memory)."""
    device: tp.Literal["cuda", "cpu"] = "cuda"
    """Where the scorers' device work runs: the card unless "cpu" is asked for."""


def get_scorer(cfg: Config, d_model: int):
    """Build (and fit, if needed) the scorer (reference :79-100). PCA takes
    no seed: it has no random state (the JAX package passes one, which its
    `MiniBatchPCA` refuses with a TypeError)."""
    if cfg.method == "sae":
        if not cfg.sae_ckpt:
            raise ValueError("sae_ckpt must be provided for method='sae'")
        return saes.SparseAutoencoderScorer(cfg.sae_ckpt, device=cfg.device)

    if cfg.baseline_run:
        return baselines.load(disk.Run(pathlib.Path(cfg.baseline_run)), device=cfg.device)

    if cfg.method == "random":
        return baselines.RandomVectors(cfg.n_prototypes, d=d_model, seed=cfg.seed)
    if cfg.method == "kmeans":
        model = baselines.MiniBatchKMeans(cfg.n_prototypes, seed=cfg.seed, device=cfg.device)
    elif cfg.method == "pca":
        model = baselines.MiniBatchPCA(cfg.n_prototypes)
    elif cfg.method == "semi-nmf":
        model = baselines.MiniBatchSemiNMF(cfg.n_prototypes, seed=cfg.seed, device=cfg.device)
    else:
        tp.assert_never(cfg.method)

    shuffled = ShuffledConfig(
        shards=cfg.train_acts.shards, layer=cfg.train_acts.layer,
        tokens=cfg.train_acts.tokens, batch_size=cfg.train_acts.batch_size,
        seed=cfg.seed,
    )
    dl = ShuffledDataLoader(shuffled)
    try:
        limited = BatchLimiter(dl, cfg.n_fit)
        for batch in helpers.progress(limited, desc=f"fit {cfg.method}"):
            model.partial_fit(batch["act"])
    finally:
        dl.shutdown()
    return model


def compute_patch_scores(
    acts_cfg: OrderedConfig, scorer, *, n_keep: int = -1, seed: int = 0,
    desc: str = "scoring",
) -> tuple[np.ndarray, np.ndarray]:
    """(scores (n, K), labels (n,)) over an ordered labeled pass
    (reference :118-182)."""
    md = Metadata.load(acts_cfg.shards)
    n_patches = md.n_examples * md.content_tokens_per_example
    keep_mask = utils.make_keep_mask(n_patches, n_keep, seed=seed)
    n_out = int(keep_mask.sum())

    scores = None
    labels = np.full((n_out,), -1, dtype=np.int64)
    dl = OrderedDataLoader(acts_cfg)
    filled = 0
    pos = 0
    try:
        for batch in helpers.progress(dl, desc=desc):
            if "token_labels" not in batch:
                raise ValueError(
                    f"{acts_cfg.shards} has no labels.bin; the FishVista "
                    "evaluation needs per-patch segmentation labels."
                )
            bsz = len(batch["act"])
            keep_b = keep_mask[pos : pos + bsz]
            pos += bsz
            if not keep_b.any():
                continue
            s = np.asarray(scorer.transform(batch["act"][keep_b]), np.float32)
            if scores is None:
                scores = np.full((n_out, s.shape[1]), -np.inf, dtype=np.float32)
            n_b = int(keep_b.sum())
            scores[filled : filled + n_b] = s
            labels[filled : filled + n_b] = batch["token_labels"][keep_b]
            filled += n_b
    finally:
        dl.shutdown()
    assert filled == n_out, (filled, n_out)
    return scores, labels


def get_best_aps(
    train_scores: np.ndarray, train_labels: np.ndarray,
    test_scores: np.ndarray, test_labels: np.ndarray,
    *, n_classes: int, seed: int = 0, chunk: int = 512,
) -> tuple[list[int], list[float], list[float]]:
    """Per class: the prototype with the best train AP, and its test AP
    (reference :185-240). Prototypes are scanned in chunks to bound the
    argsort working set; each chunk is sorted once for all classes."""
    n, k = train_scores.shape
    rng = np.random.default_rng(seed)
    best_idx = rng.integers(0, k, size=n_classes).astype(np.int64)
    best_train_ap = np.zeros(n_classes, dtype=np.float64)

    onehot = np.zeros((n, n_classes), dtype=np.float64)
    onehot[np.arange(n), np.clip(train_labels, 0, n_classes - 1)] = 1.0
    for start in helpers.progress(
        list(range(0, k, chunk)), desc="best-prototype scan", every=8
    ):
        order = np.argsort(-train_scores[:, start : start + chunk], axis=0)  # (n, kb)
        for c in range(n_classes):
            if onehot[:, c].sum() == 0:
                continue
            ap = metrics.ap_from_sorted(onehot[:, c][order])
            j = int(np.nanargmax(ap))
            if ap[j] > best_train_ap[c]:
                best_train_ap[c] = float(ap[j])
                best_idx[c] = start + j

    n_test = len(test_labels)
    test_onehot = np.zeros((n_test, n_classes), dtype=np.float64)
    test_onehot[np.arange(n_test), np.clip(test_labels, 0, n_classes - 1)] = 1.0
    picked = test_scores[:, best_idx]  # (n_test, C)
    test_ap = metrics.average_precision(picked, test_onehot)
    return (
        [int(i) for i in best_idx],
        [float(a) for a in best_train_ap],
        [float(a) if np.isfinite(a) else float("nan") for a in test_ap],
    )


def worker_fn(cfg: Config) -> utils.Result:
    """Full evaluation: fit/load scorer -> train scores -> best prototypes ->
    test AP -> dump (reference :244-323)."""
    md = Metadata.load(cfg.train_acts.shards)
    scorer = get_scorer(cfg, md.d_model)

    train_scores, train_labels = compute_patch_scores(
        cfg.train_acts, scorer, n_keep=cfg.n_train, seed=cfg.seed, desc="train scores"
    )
    test_scores, test_labels = compute_patch_scores(
        cfg.test_acts, scorer, desc="test scores"
    )
    best_idx, train_ap, test_ap = get_best_aps(
        train_scores, train_labels, test_scores, test_labels,
        n_classes=cfg.n_classes, seed=cfg.seed, chunk=cfg.ap_chunk,
    )
    finite = [a for a in test_ap if np.isfinite(a)]
    result = utils.Result(
        method=cfg.method,
        n_prototypes=train_scores.shape[1],
        best_prototype_per_class=best_idx,
        train_ap_per_class=train_ap,
        test_ap_per_class=test_ap,
        mean_ap=float(np.mean(finite)) if finite else float("nan"),
        n_train_patches=len(train_labels),
        n_test_patches=len(test_labels),
        seed=cfg.seed,
        extra={
            "vit_family": md.family,
            "vit_ckpt": md.ckpt,
            "layer": cfg.train_acts.layer,
            "sae_ckpt": cfg.sae_ckpt,
            "n_train": cfg.n_train,
        },
    )
    stem = f"fishvista_{cfg.method}_{train_scores.shape[1]}"
    if cfg.output_format in ("json", "both"):
        result.dump_json(cfg.dump_to / f"{stem}.json")
    if cfg.output_format in ("csv", "both"):
        result.dump_csv(cfg.dump_to / f"{stem}.csv")
    logger.info("%s: mAP=%.4f over %d classes.", cfg.method, result.mean_ap,
                cfg.n_classes)
    return result


def cli(cfg: Config) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
    )
    worker_fn(cfg)
