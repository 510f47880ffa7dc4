"""Activation-distribution statistics for audio against image residual
streams (counterpart of contrib/birdsong/src/birdsong/stats.py; reference
birdset notebook contrib/birdsong/notebooks/birdset.py:91-430): sample
activations from shard sets, compare their per-dimension statistics and norm
distributions, and hunt for pathological dimensions (the reference finds a
single Bird-MAE channel, d_bad=295, whose magnitude dwarfs the rest and
distorts SAE training).

Host numpy over the port's `data.IndexedDataset`; no device work.
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np

from ..data import IndexedConfig, IndexedDataset

logger = logging.getLogger("birdsong.stats")


@dataclasses.dataclass(frozen=True)
class ActStats:
    """Summary of one shard set's sampled activations."""

    n_sampled: int
    d_model: int
    mean_d: np.ndarray  # (d,) per-dimension mean
    std_d: np.ndarray  # (d,) per-dimension std
    absmax_d: np.ndarray  # (d,) per-dimension max |x|
    norms: np.ndarray  # (n,) per-token L2 norms

    @property
    def mean_norm(self) -> float:
        return float(self.norms.mean())


def sample_acts(shards: pathlib.Path, *, layer: int, n: int = 100_000, seed: int = 0) -> np.ndarray:
    """Uniform sample of `n` activation vectors from a shard set (reference
    birdset.py:91-108 streams 300k through the shuffled loader; random
    access through the indexed dataset's batch gather does the same)."""
    ds = IndexedDataset(IndexedConfig(shards=shards, layer=layer))
    rng = np.random.default_rng(seed)
    n = min(n, len(ds))
    if len(ds) <= 4 * n:
        # Small sets: exact sampling without replacement is cheap.
        idx = rng.choice(len(ds), size=n, replace=False)
    else:
        # Production sets (about 100M tokens): without replacement would
        # build an O(len(ds)) permutation; with n << N, sampling with
        # replacement is statistically the same and O(n).
        idx = rng.integers(0, len(ds), size=n)
    return ds.take(np.sort(idx))["act"]


def compute_stats(acts: np.ndarray) -> ActStats:
    acts = np.asarray(acts, np.float64)
    return ActStats(
        n_sampled=len(acts),
        d_model=acts.shape[1],
        mean_d=acts.mean(axis=0),
        std_d=acts.std(axis=0),
        absmax_d=np.abs(acts).max(axis=0),
        norms=np.linalg.norm(acts, axis=1),
    )


def outlier_dims(stats: ActStats, *, z: float = 6.0) -> list[dict]:
    """Dimensions whose |max| is far out of family (the d_bad hunt, reference
    birdset.py:237-295, :429-430): a dimension is flagged when its absmax
    exceeds `z` robust standard deviations of the absmax distribution
    (median and MAD, so one huge channel cannot mask itself)."""
    absmax = stats.absmax_d
    med = np.median(absmax)
    mad = np.median(np.abs(absmax - med)) * 1.4826 + 1e-12
    scores = (absmax - med) / mad
    flagged = np.where(scores > z)[0]
    order = flagged[np.argsort(-scores[flagged])]
    return [
        {
            "dim": int(d),
            "absmax": float(absmax[d]),
            "robust_z": float(scores[d]),
            "mean": float(stats.mean_d[d]),
            "std": float(stats.std_d[d]),
        }
        for d in order
    ]


def norm_histogram(stats: ActStats, *, bins: int = 50) -> dict:
    counts, edges = np.histogram(stats.norms, bins=bins)
    return {"counts": counts.tolist(), "edges": edges.tolist()}


def compare(a: ActStats, b: ActStats, *, names: tuple[str, str]) -> dict:
    """Side-by-side comparison of two modalities' activation statistics
    (the table behind reference birdset.py:116-236's audio-against-image
    histograms)."""

    def summary(s: ActStats) -> dict:
        return {
            "n_sampled": s.n_sampled,
            "d_model": s.d_model,
            "mean_norm": s.mean_norm,
            "std_norm": float(s.norms.std()),
            "p99_norm": float(np.percentile(s.norms, 99)),
            "max_absmax": float(s.absmax_d.max()),
            "argmax_absmax": int(s.absmax_d.argmax()),
            "n_outlier_dims": len(outlier_dims(s)),
        }

    return {
        names[0]: summary(a),
        names[1]: summary(b),
        "norm_ratio": a.mean_norm / max(b.mean_norm, 1e-12),
    }


def report(
    shard_sets: dict[str, tuple[pathlib.Path, int]],
    *,
    n: int = 100_000,
    seed: int = 0,
    out: pathlib.Path | None = None,
) -> dict:
    """The whole study over named shard sets, as a JSON-able report (and a
    file where `out` is given). shard_sets: {name: (shards_dir, layer)}."""
    all_stats: dict[str, ActStats] = {}
    result: dict[str, object] = {"per_set": {}, "comparisons": {}}
    for name, (shards, layer) in shard_sets.items():
        stats = compute_stats(sample_acts(shards, layer=layer, n=n, seed=seed))
        all_stats[name] = stats
        result["per_set"][name] = {
            "n_sampled": stats.n_sampled,
            "d_model": stats.d_model,
            "mean_norm": stats.mean_norm,
            "outlier_dims": outlier_dims(stats),
            "norm_histogram": norm_histogram(stats),
        }
        logger.info("%s: %d sampled, mean norm %.2f, %d outlier dims.", name, stats.n_sampled, stats.mean_norm,
                    len(result["per_set"][name]["outlier_dims"]))
    names = list(all_stats)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            result["comparisons"][f"{names[i]}_vs_{names[j]}"] = compare(
                all_stats[names[i]], all_stats[names[j]], names=(names[i], names[j]))
    if out is not None:
        pathlib.Path(out).write_text(json.dumps(result, indent=2))
        logger.info("Wrote report to %s.", out)
    return result
