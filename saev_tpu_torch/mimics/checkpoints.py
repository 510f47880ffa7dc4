"""Classifier-checkpoint discovery + feature pooling for the heliconius
exploration workflow (counterpart of contrib/mimics/src/mimics/checkpoints.py;
the reference's exploration notebook, contrib/mimics/exps/001-heliconius/
exploration.py, drives `mimics.checkpoints.discover_checkpoints` and
`mimics.features`, modules its repo never shipped), against the
`tdiscovery.classification` checkpoints (`cls_{task}_{agg}_{cls}.pkl`,
header+pickle):

1. Step 1: scan run dirs for a task's classifier checkpoints -> ckpt table.
2. Step 2: select checkpoints by feature count / rank, pool their top
   features per class.
3. Step 3: build a render plan pairing each class with its pooled latents.

Host-only; reading a checkpoint unpickles its scikit-learn head.
"""

import dataclasses
import json
import logging
import pathlib
import pickle

import numpy as np

logger = logging.getLogger("mimics.checkpoints")


@dataclasses.dataclass(frozen=True)
class DiscoverCheckpointsConfig:
    run_root_dpath: pathlib.Path
    """Directory holding run dirs (saev/runs)."""
    shard_id: str
    """Shard-hash directory name under each run's inference/."""
    task_name: str
    run_ids: tuple[str, ...] = ()
    """Runs to scan; empty = every directory under run_root_dpath."""
    c_values: tuple[float, ...] = ()
    """Keep only sparse-linear heads with these C values (empty = all)."""


def _ckpt_rows(fpath: pathlib.Path, run_id: str, task_name: str) -> dict | None:
    from ..tdiscovery import classification as cls_mod

    try:
        header, payload = cls_mod.load_classifier_checkpoint(fpath)
    except (json.JSONDecodeError, pickle.UnpicklingError, OSError) as err:
        logger.warning("Unreadable checkpoint %s: %s", fpath, err)
        return None
    clf = payload["classifier"]
    ranked_i, importance = cls_mod.extract_feature_ranking(clf)
    # The checkpoint writer's header schema (classification.train_worker_fn):
    # {"cfg": asdict(TrainConfig), "test_acc", "n_classes", "class_names"};
    # the head config lives at cfg["cls"] ({"key", "C"/"max_depth", ...}).
    cfg_hdr = header.get("cfg", {}) if isinstance(header.get("cfg"), dict) else {}
    cls_cfg = cfg_hdr.get("cls", {}) if isinstance(cfg_hdr.get("cls"), dict) else {}
    return {
        "run_id": run_id,
        "task_name": task_name,
        "ckpt_fpath": str(fpath),
        "cls_type": cls_cfg.get("key", type(clf).__name__),
        "c_value": cls_cfg.get("C"),
        "n_features": int((importance > 0).sum()),
        "d_sae": int(len(importance)),
        "test_acc": header.get("test_acc"),
        "ranked_i": ranked_i,
        "importance": importance,
    }


def discover_checkpoints(cfg: DiscoverCheckpointsConfig) -> list[dict]:
    """One row per classifier checkpoint for `task_name` found under the runs
    (exploration.py Step 1)."""
    run_ids = list(cfg.run_ids) or sorted(
        p.name for p in pathlib.Path(cfg.run_root_dpath).iterdir() if p.is_dir()
    )
    rows = []
    for run_id in run_ids:
        art = pathlib.Path(cfg.run_root_dpath) / run_id / "inference" / cfg.shard_id
        if not art.is_dir():
            continue
        for fpath in sorted(art.glob(f"cls_{cfg.task_name}_*.pkl")):
            row = _ckpt_rows(fpath, run_id, cfg.task_name)
            if row is None:
                continue
            if cfg.c_values and not any(
                row["c_value"] is not None and abs(row["c_value"] - c) < 1e-12
                for c in cfg.c_values
            ):
                continue
            rows.append(row)
    logger.info(
        "Found %d checkpoints for task %r across %d runs.",
        len(rows), cfg.task_name, len({r['run_id'] for r in rows}),
    )
    return rows


def get_empty_ckpt_df() -> list[dict]:
    return []


def select_checkpoints(
    rows: list[dict],
    *,
    n_features_range: tuple[int, int] | None = None,
    top_k: int | None = None,
) -> list[dict]:
    """Filter by nonzero-feature count and keep the top_k by test accuracy
    (exploration.py Step 1 sliders)."""
    out = rows
    if n_features_range is not None:
        lo, hi = n_features_range
        out = [r for r in out if lo <= r["n_features"] <= hi]
    out = sorted(out, key=lambda r: -(r["test_acc"] or 0.0))
    return out[:top_k] if top_k else out


def pool_features(rows: list[dict], *, per_ckpt: int = 10) -> dict[int, float]:
    """Union the top-`per_ckpt` features of every selected checkpoint,
    accumulating importance (exploration.py Step 2). Returns
    {latent: total importance} sorted descending."""
    pooled: dict[int, float] = {}
    for row in rows:
        for latent in row["ranked_i"][:per_ckpt]:
            latent = int(latent)
            pooled[latent] = pooled.get(latent, 0.0) + float(
                row["importance"][latent]
            )
    return dict(sorted(pooled.items(), key=lambda kv: -kv[1]))


def build_render_plan(
    labels: list[str],
    features: dict[int, float],
    *,
    groups: dict[str, list[str]],
    n_per_class: int = 4,
    seed: int = 0,
) -> list[dict]:
    """(class, example, latents) rows for the render module (Step 3): sample
    n_per_class examples per task side, each to be rendered with every pooled
    latent's activation heatmap."""
    rng = np.random.default_rng(seed)
    latents = list(features)
    plan = []
    for cls_name, members in groups.items():
        member_set = set(members)
        pool = [i for i, lab in enumerate(labels) if lab in member_set]
        if not pool:
            logger.warning("No examples labeled %s; skipping.", cls_name)
            continue
        pick = rng.choice(pool, size=min(n_per_class, len(pool)), replace=False)
        for example_idx in sorted(int(i) for i in pick):
            plan.append({
                "class": cls_name,
                "example_idx": example_idx,
                "latents": latents,
            })
    return plan
