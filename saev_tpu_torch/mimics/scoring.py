"""Score every SAE latent for two-class (mimic pair) discrimination by AUROC
(counterpart of contrib/mimics/src/mimics/scoring.py; reference TaskSpec :77,
build_task_specs :88, max_pool_csr :124, score_run :145): given image-level
labels and per-token SAE activations, max-pool to image level and compute
per-latent AUROC for each binary task, chunked over latents to bound memory.
Host-only numpy.
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np
import scipy.sparse

from .. import disk
from ..data import Metadata

logger = logging.getLogger("mimics.scoring")


@dataclasses.dataclass(frozen=True)
class Config:
    """Score all SAE latents for pair discrimination (reference scoring.py:36-72)."""

    run: pathlib.Path = pathlib.Path("./runs/abcdefg")
    """SAE run directory."""
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    """Shards used for labels + activations."""
    labels: tuple[str, ...] = ()
    """Per-image class labels in dataset order."""
    pairs: tuple[tuple[str, str], ...] = ()
    """(class_a, class_b) pairs to score; b is the positive class."""
    min_samples: int = 10
    """Minimum images per class to include a task."""
    feature_chunk: int = 1024
    """Latents per AUROC chunk (controls peak memory)."""
    force_recompute: bool = False


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    include: np.ndarray  # bool (n_images,)
    binary: np.ndarray  # int8 over included images; 1 = positive class
    n_pos: int
    n_neg: int


def build_task_specs(
    labels: list[str],
    *,
    pairs: list[tuple[str, str]],
    min_samples: int,
) -> list[TaskSpec]:
    labels_arr = np.asarray(labels)
    specs = []
    for a, b in pairs:
        mask_a = labels_arr == a
        mask_b = labels_arr == b
        if mask_a.sum() < min_samples or mask_b.sum() < min_samples:
            continue
        include = mask_a | mask_b
        binary = mask_b[include].astype(np.int8)
        specs.append(
            TaskSpec(
                name=f"{a}_vs_{b}",
                include=include,
                binary=binary,
                n_pos=int(mask_b.sum()),
                n_neg=int(mask_a.sum()),
            )
        )
    return specs


def max_pool_csr(
    ta_csr: scipy.sparse.csr_matrix, n_images: int, tpi: int
) -> np.ndarray:
    """Max-pool token-level sparse activations to image level
    (reference scoring.py:124-135)."""
    ta_csr = ta_csr.tocsr()
    result = np.zeros((n_images, ta_csr.shape[1]), dtype=np.float32)
    for i in range(n_images):
        s = ta_csr.indptr[i * tpi]
        e = ta_csr.indptr[i * tpi + tpi]
        if s < e:
            np.maximum.at(result[i], ta_csr.indices[s:e], ta_csr.data[s:e])
    return result


def auroc_per_latent(
    scores_nd: np.ndarray, binary_n: np.ndarray, *, chunk: int = 1024
) -> np.ndarray:
    """Per-latent AUROC via the rank-sum (Mann-Whitney U) identity, chunked
    over latents. Ties get average ranks."""
    n, d = scores_nd.shape
    n_pos = int(binary_n.sum())
    n_neg = n - n_pos
    assert n_pos > 0 and n_neg > 0
    out = np.empty(d, dtype=np.float64)
    pos = binary_n.astype(bool)
    for c0 in range(0, d, chunk):
        c1 = min(c0 + chunk, d)
        block = scores_nd[:, c0:c1]
        order = np.argsort(block, axis=0, kind="stable")
        ranks = np.empty_like(order, dtype=np.float64)
        np.put_along_axis(
            ranks, order, np.arange(1, n + 1, dtype=np.float64)[:, None], axis=0
        )
        # Average ranks across ties (columnwise).
        for j in range(c1 - c0):
            col = block[:, j]
            uniq, inv, counts = np.unique(col, return_inverse=True, return_counts=True)
            if len(uniq) < n:
                sums = np.zeros(len(uniq))
                np.add.at(sums, inv, ranks[:, j])
                ranks[:, j] = sums[inv] / counts[inv]
        r_pos = ranks[pos].sum(axis=0)
        out[c0:c1] = (r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    return out


def score_run(cfg: Config) -> dict[str, object]:
    """Score every latent on every task; write mimic_scores.json
    (reference score_run, scoring.py:145-209)."""
    run = disk.Run(cfg.run)
    md = Metadata.load(cfg.shards)
    assert len(cfg.labels) == md.n_examples

    out_fpath = run.inference / cfg.shards.name / "mimic_scores.json"
    if out_fpath.exists() and not cfg.force_recompute:
        logger.info("Scores exist at %s; skipping.", out_fpath)
        return json.loads(out_fpath.read_text())

    ta = scipy.sparse.load_npz(run.inference / cfg.shards.name / "token_acts.npz")
    pooled = max_pool_csr(ta, md.n_examples, md.content_tokens_per_example)

    specs = build_task_specs(
        list(cfg.labels), pairs=list(cfg.pairs), min_samples=cfg.min_samples
    )
    results: dict[str, object] = {}
    for spec in specs:
        auroc = auroc_per_latent(
            pooled[spec.include], spec.binary, chunk=cfg.feature_chunk
        )
        # Direction-free separation: max(auroc, 1-auroc).
        sep = np.maximum(auroc, 1 - auroc)
        best = int(sep.argmax())
        results[spec.name] = {
            "best_latent": best,
            "best_auroc": float(auroc[best]),
            "best_separation": float(sep[best]),
            "n_pos": spec.n_pos,
            "n_neg": spec.n_neg,
            "top10": [
                {"latent": int(i), "auroc": float(auroc[i])}
                for i in np.argsort(-sep)[:10]
            ],
        }
        logger.info(
            "task %s: best separation %.3f (latent %d)",
            spec.name, sep[best], best,
        )

    with open(out_fpath, "w") as fd:
        json.dump(results, fd, indent=2)
    return results
