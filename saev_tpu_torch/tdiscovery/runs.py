"""Run-artifact loading for figures and tables: RunSpec and load_df
(counterpart of contrib/trait_discovery/src/tdiscovery/runs.py).

Capability mirror of the reference's figure-notebook data interface
(contrib/trait_discovery/notebooks/figures.py:9-420: `RunSpec` + `load_df`
is "the single data-loading interface" for every paper figure/table). Scans
each run's inference dirs and assembles ONE tidy DataFrame row per run with
shard-prefixed columns:

- `<shard>/<metric>` from metrics.json (reconstruction metrics),
- `<shard>/trait_<metric>` from trait_metrics.json (probe AP/purity),
- `<shard>/cls_<task>_<metric>` from classification_<task>.json,
- `<shard>/audit_auc_b` (best AUC_B over audited classifiers),
- `<shard>/probe_r` — mean best-per-class probe score from
  probe1d_metrics.npz (the local probe summary),
- config columns (`activation`, `d_sae`, `lr`, ...) from the run's
  config.json when present.

Loader helpers only ADD columns; aggregation/selection stays in the figure
functions (the reference's stated coding style, figures.py:14-29).
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np

from .. import helpers

logger = logging.getLogger("td.runs")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One run to load, with optional provenance notes (reference
    figures.py RunSpec)."""

    run: pathlib.Path
    """Run directory (runs/<id>)."""
    method: str = "sae"
    """Method label for grouping (sae / pca / kmeans / supervised ...)."""
    note: str = ""
    """Provenance note (sweep file, tag, figure reference)."""


def _flat(prefix: str, dct: dict, out: dict) -> None:
    for key, value in dct.items():
        if isinstance(value, (int, float, str, bool)) or value is None:
            out[f"{prefix}{key}"] = value
        elif isinstance(value, dict):
            # trait_metrics.json nests purity@k as {"mean": ..., "min": ...};
            # flatten to <key>_<stat> so the promised purity columns exist.
            _flat(f"{prefix}{key}_", value, out)


def _load_one(spec: RunSpec) -> dict:
    row: dict[str, object] = {
        "run_id": pathlib.Path(spec.run).name,
        "method": spec.method,
        "note": spec.note,
    }

    cfg_fpath = pathlib.Path(spec.run) / "checkpoint" / "config.json"
    if cfg_fpath.exists():
        cfg = json.loads(cfg_fpath.read_text())
        sae = cfg.get("sae", {})
        act = sae.get("activation", {})
        row["d_sae"] = sae.get("d_sae")
        row["activation"] = act.get("key", act.get("kind"))
        row["top_k"] = act.get("top_k")
        row["lr"] = cfg.get("lr")
        row["optim"] = cfg.get("optim")
        row["seed"] = cfg.get("seed")

    inference = pathlib.Path(spec.run) / "inference"
    if not inference.is_dir():
        return row

    for shard_dir in sorted(p for p in inference.iterdir() if p.is_dir()):
        shard = shard_dir.name
        m_fpath = shard_dir / "metrics.json"
        if m_fpath.exists():
            _flat(f"{shard}/", json.loads(m_fpath.read_text()), row)
        t_fpath = shard_dir / "trait_metrics.json"
        if t_fpath.exists():
            _flat(f"{shard}/trait_", json.loads(t_fpath.read_text()), row)
        for c_fpath in sorted(shard_dir.glob("classification_*.json")):
            task = c_fpath.stem.removeprefix("classification_")
            _flat(f"{shard}/cls_{task}_", json.loads(c_fpath.read_text()), row)
        a_fpath = shard_dir / "audit_results.json"
        if a_fpath.exists():
            audit = json.loads(a_fpath.read_text())
            aucs = [c.get("auc_b") for c in audit.get("classifiers", [])]
            aucs = [a for a in aucs if a is not None]
            if aucs:
                row[f"{shard}/audit_auc_b"] = max(aucs)
        p_fpath = shard_dir / "probe1d_metrics.npz"
        if p_fpath.exists():
            with np.load(p_fpath) as fd:
                loss_lc = fd["loss"]
            # Local probe summary: mean over classes of the best (lowest-loss)
            # latent's probe loss, negated so bigger = better like the
            # reference's probe_r column.
            row[f"{shard}/probe_r"] = float(-loss_lc.min(axis=0).mean())

    return row


def load_df(specs: list[RunSpec]):
    """(DataFrame of one row per loadable run, list of skipped specs)."""
    pd = helpers.optional_import("pandas", "tdiscovery.runs")

    rows, skipped = [], []
    for spec in specs:
        if not pathlib.Path(spec.run).is_dir():
            skipped.append(spec)
            logger.warning("Skipping missing run %s.", spec.run)
            continue
        rows.append(_load_one(spec))
    return pd.DataFrame(rows), skipped


def shard_columns(df, shard: str, *, suffix: str = "") -> list[str]:
    """Column names for one shard (optionally filtered by metric suffix)."""
    prefix = f"{shard}/"
    return [
        c for c in df.columns if c.startswith(prefix) and c.endswith(suffix)
    ]


def pareto_front(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Boolean mask of (x, y) points on the minimize-x / minimize-y frontier
    (the L0-vs-NMSE plots; reference figures.py pareto helpers)."""
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    # Ties on x are the COMMON case (top-k SAEs share exactly equal L0): sort
    # by (x, y) so only the min-y point of each x can enter the front — a
    # same-x worse-y point is dominated.
    order = np.lexsort((ys, xs))
    keep = np.zeros(len(xs), dtype=bool)
    best = np.inf
    for i in order:
        if ys[i] < best:
            keep[i] = True
            best = ys[i]
    return keep
