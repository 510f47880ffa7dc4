"""Cambridge mimic-pair feature discrimination analysis (counterpart of
contrib/trait_discovery/src/tdiscovery/mimicry.py).

Capability port of the reference's 007_cambridge_mimicry notebook
(`contrib/trait_discovery/notebooks/007_cambridge_mimicry.py:102-805`). The
study: Heliconius erato and H. melpomene subspecies form mimicry pairs that
look nearly identical; for each (erato ssp, melpomene ssp) pair x wing view,
train a sparse linear head on SAE image features to tell them apart, then ask
which pairs are separable, at what sparsity cost, and which latents carry the
discrimination. This module turns a runs root full of `cls_*.pkl` checkpoints
(written by `tdiscovery.classification.train_worker_fn`) into:

- `pair_counts`: per-task class balance, majority accuracy, and an
  insufficient-data flag (reference get_pair_counts_df :164-224);
- `harvest_results`: one row per checkpoint with balanced accuracy recomputed
  from the SAVED predictions, nonzero feature ids + signed weights
  (positive => melpomene for binary heads; reference get_results_df :227-335);
- `difficulty_table` / `sparsity_tradeoff` / `rank_features`: the notebook's
  downstream cross-pair difficulty, accuracy-vs-sparsity and feature-ranking
  views (:345-805).
"""

import dataclasses
import logging
import pathlib

import numpy as np

from . import classification as cls_mod

logger = logging.getLogger("td.mimicry")


def task_name(erato_ssp: str, melp_ssp: str, view: str) -> str:
    return f"{erato_ssp}_{view}_vs_{melp_ssp}_{view}"


def pretty_task_name(name: str) -> str:
    return name.replace("_vs_", " vs ").replace("_", " ")


def pair_task(erato_ssp: str, melp_ssp: str, view: str) -> cls_mod.LabelGrouping:
    """The two-class grouping over the 'subspecies_view' label column."""
    return cls_mod.LabelGrouping(
        name=task_name(erato_ssp, melp_ssp, view),
        source_col="subspecies_view",
        groups={
            "erato": [f"{erato_ssp}_{view}"],
            "melpomene": [f"{melp_ssp}_{view}"],
        },
    )


def run_id_from_ckpt_fpath(fpath: pathlib.Path) -> str:
    """runs/<id>/inference/<shard>/cls_*.pkl → <id>."""
    parts = fpath.parts
    assert "inference" in parts, f"'inference' not in checkpoint path: {fpath}"
    i = parts.index("inference")
    assert i > 0, f"cannot parse run id from {fpath}"
    return parts[i - 1]


# ---------------------------------------------------------------------------
# Pair counts (reference get_pair_counts_df)
# ---------------------------------------------------------------------------


def pair_counts(
    shards: pathlib.Path,
    mimic_pairs: list[tuple[str, str]],
    views: tuple[str, ...] = ("dorsal", "ventral"),
    *,
    min_samples_per_class: int = 10,
) -> list[dict[str, object]]:
    """Per-task sample counts over one shard dir's image labels."""
    _, labels_by_col = cls_mod.load_image_labels(shards)
    assert "subspecies_view" in labels_by_col, (
        f"Expected 'subspecies_view' labels in {shards}"
    )
    ssp_view = labels_by_col["subspecies_view"]

    rows = []
    for erato_ssp, melp_ssp in mimic_pairs:
        for view in views:
            task = pair_task(erato_ssp, melp_ssp, view)
            y, class_names = task.apply(ssp_view)
            class_to_i = {n: i for i, n in enumerate(class_names)}
            assert {"erato", "melpomene"} <= set(class_to_i)
            kept = y[y >= 0]
            n_erato = int((kept == class_to_i["erato"]).sum())
            n_melp = int((kept == class_to_i["melpomene"]).sum())
            n_total = n_erato + n_melp
            rows.append({
                "task": task.name,
                "n_erato": n_erato,
                "n_melpomene": n_melp,
                "n_total": n_total,
                "majority_acc": (
                    None if n_total == 0 else max(n_erato, n_melp) / n_total
                ),
                "insufficient_data": min(n_erato, n_melp) < min_samples_per_class,
            })
    return rows


# ---------------------------------------------------------------------------
# Checkpoint harvesting (reference get_results_df)
# ---------------------------------------------------------------------------


def balanced_accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean per-class recall (sklearn.metrics.balanced_accuracy_score)."""
    recalls = []
    for c in np.unique(y_true):
        mask = y_true == c
        recalls.append(float((y_pred[mask] == c).mean()))
    return float(np.mean(recalls))


@dataclasses.dataclass(frozen=True)
class HarvestFilter:
    """Which checkpoints count (reference :255-266): sparse-linear heads with
    max patch aggregation and an allowed C, on a known task."""

    tasks: frozenset[str]
    c_values: frozenset[float] = frozenset({0.01, 0.1, 1.0})
    patch_agg: str = "max"


def harvest_results(
    runs_root: pathlib.Path,
    *,
    filt: HarvestFilter,
    run_to_layer: dict[str, int] | None = None,
) -> list[dict[str, object]]:
    """Scan every runs/<id>/inference/<shard>/cls_*.pkl and build the results
    frame. Unreadable checkpoints are logged and skipped, filtered ones are
    silently dropped — identical to the reference's error policy."""
    rows = []
    for ckpt_fpath in sorted(pathlib.Path(runs_root).glob("*/inference/*/cls_*.pkl")):
        # run_id is derivable from the path alone; filter BEFORE unpickling
        # the fitted classifier + prediction arrays.
        run_id = run_id_from_ckpt_fpath(ckpt_fpath)
        if run_to_layer is not None and run_id not in run_to_layer:
            continue
        try:
            header, payload = cls_mod.load_classifier_checkpoint(ckpt_fpath)
        except Exception as err:
            logger.warning("Failed loading %s: %s", ckpt_fpath, err)
            continue

        cfg = header["cfg"]
        if cfg["task"]["name"] not in filt.tasks:
            continue
        agg = cfg["patch_agg"]
        agg = agg.split(".")[-1].lower() if isinstance(agg, str) else agg
        if agg != filt.patch_agg:
            continue
        cls_cfg = cfg["cls"]
        if cls_cfg.get("key", "sparse-linear") != "sparse-linear":
            continue
        if "C" in cls_cfg and float(cls_cfg["C"]) not in filt.c_values:
            continue

        test_y = np.asarray(payload["test_y"])
        test_pred = np.asarray(payload["test_pred"])
        if test_y.size == 0:
            continue
        assert test_y.shape == test_pred.shape, f"Shape mismatch in {ckpt_fpath}"

        coef = np.asarray(payload["classifier"].coef_)
        nonzero = np.any(coef != 0, axis=0)
        features = np.where(nonzero)[0].tolist()
        # Binary head: one coef row; its sign points at class 1 (melpomene).
        weights = coef[0, nonzero].tolist() if coef.shape[0] == 1 else []

        n_classes = int(header["n_classes"])
        class_names = [str(n) for n in header["class_names"]]
        counts = np.bincount(test_y, minlength=n_classes)
        n_examples = int(counts.sum())
        if n_examples == 0:
            continue
        class_to_i = {n: i for i, n in enumerate(class_names)}

        rows.append({
            "shard_id": ckpt_fpath.parent.name,
            "run_id": run_id,
            "layer": None if run_to_layer is None else run_to_layer[run_id],
            "task": cfg["task"]["name"],
            "C": float(cls_cfg.get("C", float("nan"))),
            "test_acc": float(header["test_acc"]),
            "balanced_acc": balanced_accuracy(test_y, test_pred),
            "majority_acc": float(counts.max() / n_examples),
            "n_nonzero": int(nonzero.sum()),
            "features": features,
            "weights": weights,
            "n_examples": n_examples,
            "n_erato_test": (
                int(counts[class_to_i["erato"]]) if "erato" in class_to_i else None
            ),
            "n_melpomene_test": (
                int(counts[class_to_i["melpomene"]])
                if "melpomene" in class_to_i
                else None
            ),
            "ckpt_fpath": str(ckpt_fpath),
        })
    return rows


# ---------------------------------------------------------------------------
# Downstream views (reference :345-805)
# ---------------------------------------------------------------------------


def difficulty_table(rows: list[dict[str, object]]) -> list[dict[str, object]]:
    """Per task: the best balanced accuracy over all (run, C) and its margin
    over CHANCE — the cross-pair difficulty ranking, hardest first.

    The baseline for balanced accuracy is 0.5 (a majority classifier's
    balanced accuracy on a binary task), NOT the raw majority-class rate:
    subtracting the raw rate mixes metrics and makes a discriminating head on
    an imbalanced split look at-or-below baseline. The raw majority_acc stays
    in the row as context for test_acc."""
    by_task: dict[str, list[dict[str, object]]] = {}
    for row in rows:
        by_task.setdefault(row["task"], []).append(row)
    out = []
    for task, members in by_task.items():
        best = max(members, key=lambda r: r["balanced_acc"])
        out.append({
            "task": task,
            "pretty": pretty_task_name(task),
            "best_balanced_acc": best["balanced_acc"],
            "majority_acc": best["majority_acc"],
            "margin": best["balanced_acc"] - 0.5,
            "best_C": best["C"],
            "best_n_nonzero": best["n_nonzero"],
            "n_checkpoints": len(members),
        })
    return sorted(out, key=lambda r: r["best_balanced_acc"])


def sparsity_tradeoff(rows: list[dict[str, object]]) -> list[dict[str, object]]:
    """Per C: mean nonzero-feature count vs mean balanced accuracy — the
    accuracy-you-buy-per-feature curve."""
    by_c: dict[float, list[dict[str, object]]] = {}
    for row in rows:
        by_c.setdefault(row["C"], []).append(row)
    return [
        {
            "C": c,
            "mean_n_nonzero": float(np.mean([r["n_nonzero"] for r in members])),
            "mean_balanced_acc": float(
                np.mean([r["balanced_acc"] for r in members])
            ),
            "n": len(members),
        }
        for c, members in sorted(by_c.items())
    ]


def rank_features(row: dict[str, object], top_k: int = 10) -> list[dict[str, object]]:
    """The |weight|-ranked latents of one harvested head, with the class the
    sign points at (positive => melpomene)."""
    feats = np.asarray(row["features"], dtype=int)
    weights = np.asarray(row["weights"], dtype=float)
    assert feats.shape == weights.shape, "harvest row has no binary weights"
    order = np.argsort(-np.abs(weights))[:top_k]
    return [
        {
            "latent": int(feats[i]),
            "weight": float(weights[i]),
            "points_at": "melpomene" if weights[i] > 0 else "erato",
        }
        for i in order
    ]
