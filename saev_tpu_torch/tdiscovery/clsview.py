"""Classification-results analysis: eval artifacts -> frames, rules, tables
(counterpart of contrib/trait_discovery/src/tdiscovery/clsview.py; reference
notebooks/004_fishbase_cls.py get_cls_results_fpaths/get_cls_results
:382-431, the sparse-classifier display cells :432-520, print_tree :459-520,
idx_to_label :521-566): aggregate every `classification_<task>.json` eval
artifact across runs into a dataframe (joined with SAE run metadata), render
trained decision-tree heads as latent-threshold rules, and tabulate the top
latents per class from linear heads. Host-only: pandas for the frames and
scikit-learn for the rules, each imported where used.
"""

import json
import logging
import pathlib

import numpy as np

from .. import disk, helpers
from . import analysis

logger = logging.getLogger("tdiscovery.clsview")


def cls_results_fpaths(run_dir: pathlib.Path) -> list[pathlib.Path]:
    """Every classification eval artifact under a run's inference dirs
    (reference get_cls_results_fpaths :382-409)."""
    inference = pathlib.Path(run_dir) / "inference"
    if not inference.is_dir():
        return []
    return sorted(inference.glob("*/classification_*.json"))


def load_cls_results_df(
    run_dirs: list[pathlib.Path] | tuple[pathlib.Path, ...],
    *,
    tracker_root: pathlib.Path | None = None,
    per_class: bool = False,
):
    """Classification evals across runs as a dataframe (reference
    get_cls_results :410-431 + the polars assembly cell).

    One row per (run, shards, task) with accuracy/mAP/n_test and the SAE
    run-record columns; `per_class=True` explodes to one row per class with
    its AP and top latents.
    """
    pd = helpers.optional_import("pandas", "tdiscovery.clsview")

    rows = []
    for run_dir in run_dirs:
        try:
            run = disk.Run(pathlib.Path(run_dir))
        except (ValueError, FileNotFoundError) as err:
            logger.info("Skipping %s: %s", run_dir, err)
            continue
        fpaths = cls_results_fpaths(run.run_dir)
        if not fpaths:
            continue
        try:
            record = analysis.run_record(run, tracker_root)
        except FileNotFoundError:
            record = {"run_id": run.run_id}
        base = {
            "run_id": record.get("run_id", run.run_id),
            "model": record.get("model_key"),
            "layer": record.get("config/val_data/layer"),
            "objective": record.get("objective"),
            "sae_val_l0": record.get("summary/eval/l0"),
            "sae_val_nmse": record.get("summary/eval/normalized_mse"),
        }
        for fpath in fpaths:
            results = json.loads(fpath.read_text())
            task = fpath.stem.removeprefix("classification_")
            common = {
                **base,
                "shard": fpath.parent.name,
                "task": task,
                "accuracy": float(results["accuracy"]),
                "mean_ap": float(results["mean_ap"]),
                "n_test": int(results["n_test"]),
                "n_classes": len(results["class_names"]),
            }
            if not per_class:
                rows.append(common)
                continue
            for idx, name in enumerate(results["class_names"]):
                rows.append({
                    **common,
                    "class_idx": idx,
                    "class_name": name,
                    "ap": float(results["ap_per_class"][idx]),
                    "top_latents": list(
                        results["top_features_per_class"][idx]
                    ),
                })
    df = pd.DataFrame(rows)
    logger.info("Classification results: %d rows over %d runs.", len(df),
                df["run_id"].nunique() if len(df) else 0)
    return df


def tree_rules(clf, class_names: list[str], *, max_depth: int | None = None) -> str:
    """A trained decision-tree head as human-readable latent-threshold rules
    (reference print_tree :459-520). Feature j renders as `latent j`, leaves
    as the majority class name."""
    sklearn_tree = helpers.optional_import("sklearn.tree", "tdiscovery.clsview.tree_rules")

    n_features = clf.tree_.n_features
    text = sklearn_tree.export_text(
        clf,
        feature_names=[f"latent {j}" for j in range(n_features)],
        class_names=[str(class_names[int(c)]) for c in clf.classes_],
        max_depth=max_depth if max_depth is not None else 10,
    )
    return text


def top_latents_table(results: dict, *, k: int = 10):
    """Per-class top-latent table from one classification_<task>.json payload:
    class name, AP, and the first `k` most-important latents (reference's
    habitat/top-latent display cells :544-572)."""
    pd = helpers.optional_import("pandas", "tdiscovery.clsview")

    rows = []
    for idx, name in enumerate(results["class_names"]):
        rows.append({
            "class_idx": idx,
            "class_name": name,
            "ap": float(results["ap_per_class"][idx]),
            "top_latents": list(results["top_features_per_class"][idx])[:k],
        })
    return pd.DataFrame(rows).sort_values("ap", ascending=False).reset_index(
        drop=True
    )


def latent_class_matrix(clf, n_classes: int) -> np.ndarray:
    """(n_classes, d_sae) signed coefficient matrix of a linear head, rows
    aligned to the class-name index space. Shared with eval_worker_fn: the
    sklearn classes_-alignment rule lives once, in classification.py."""
    from . import classification

    return classification.latent_class_matrix(clf, n_classes)


def shared_latents(results: dict, *, k: int = 10) -> dict[int, list[str]]:
    """Latents that rank in the top `k` for more than one class — candidate
    shared/polysemantic features (reference's overlap exploration)."""
    by_latent: dict[int, list[str]] = {}
    for name, top in zip(results["class_names"], results["top_features_per_class"]):
        for latent in list(top)[:k]:
            by_latent.setdefault(int(latent), []).append(str(name))
    return {
        latent: names for latent, names in sorted(by_latent.items())
        if len(names) > 1
    }
