"""Cross-run feature consistency for mimic tasks (counterpart of
contrib/mimics/src/mimics/consistency.py; reference `launch.py consistency`,
browsed by exps/001-heliconius/viewer.py:1-600 via its "Feature order:
consistency" mode): a discriminative latent is trustworthy when INDEPENDENT
runs (different seeds/widths) learn the same feature. Two latents from
different runs are "the same feature" when their max-pooled per-image
activation profiles correlate: the image set is shared across runs, so the
profiles are directly comparable without weight-space alignment.

For every task and every run, each of the run's top-separation latents gets

    consistency = max over other runs, max over THEIR top latents of
                  Pearson r(pooled_acts[:, latent], other_pooled[:, latent'])

and the per-run artifact `mimic_consistency.json` records the score plus the
best-matching (run, latent) witness. Host-only numpy.
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np
import scipy.sparse

from .. import disk
from ..data import Metadata
from . import scoring

logger = logging.getLogger("mimics.consistency")


@dataclasses.dataclass(frozen=True)
class Config:
    runs: tuple[pathlib.Path, ...] = ()
    """Run directories to compare (>= 2)."""
    shards: pathlib.Path = pathlib.Path("./shards/abcdef01")
    task_names: tuple[str, ...] = ()
    """Tasks to process; empty = every task scored in ALL runs."""
    top_k: int = 10
    """Candidate latents per (run, task): the scored top10 capped here."""


def _pooled(run_dir: pathlib.Path, shards: pathlib.Path, md: Metadata) -> np.ndarray:
    run = disk.Run(run_dir)
    ta = scipy.sparse.load_npz(
        run.inference / shards.name / "token_acts.npz"
    )
    return scoring.max_pool_csr(ta, md.n_examples, md.content_tokens_per_example)


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    if denom == 0:
        return 0.0
    return float(a @ b / denom)


def worker_fn(cfg: Config) -> dict[str, dict]:
    assert len(cfg.runs) >= 2, "Consistency needs at least two runs."
    md = Metadata.load(cfg.shards)

    scores_by_run: dict[str, dict] = {}
    pooled_by_run: dict[str, np.ndarray] = {}
    for run_dir in cfg.runs:
        run = disk.Run(run_dir)
        fpath = run.inference / cfg.shards.name / "mimic_scores.json"
        scores_by_run[str(run_dir)] = json.loads(fpath.read_text())
        pooled_by_run[str(run_dir)] = _pooled(run_dir, cfg.shards, md)

    tasks = list(cfg.task_names) or sorted(
        set.intersection(*(set(s) for s in scores_by_run.values()))
    )
    assert tasks, "No common scored tasks across runs."

    results: dict[str, dict] = {str(r): {} for r in cfg.runs}
    for task in tasks:
        candidates = {
            run_key: [
                int(item["latent"])
                for item in scores_by_run[run_key][task]["top10"][: cfg.top_k]
            ]
            for run_key in scores_by_run
        }
        for run_key, latents in candidates.items():
            entries = []
            for latent in latents:
                profile = pooled_by_run[run_key][:, latent]
                best = {"score": -1.0, "run": None, "latent": None}
                for other_key, other_latents in candidates.items():
                    if other_key == run_key:
                        continue
                    for ol in other_latents:
                        r = _corr(profile, pooled_by_run[other_key][:, ol])
                        if r > best["score"]:
                            best = {"score": r, "run": other_key, "latent": ol}
                entries.append({
                    "latent": latent,
                    "consistency": round(best["score"], 6),
                    "witness_run": best["run"],
                    "witness_latent": best["latent"],
                })
            entries.sort(key=lambda e: -e["consistency"])
            results[run_key][task] = entries

    for run_dir in cfg.runs:
        run = disk.Run(run_dir)
        out = run.inference / cfg.shards.name / "mimic_consistency.json"
        out.write_text(json.dumps(results[str(run_dir)], indent=2))
        logger.info("Wrote %s.", out)
    return results
