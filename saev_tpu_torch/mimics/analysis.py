"""Width-sweep analysis for the wider-SAEs experiment (counterpart of
contrib/mimics/src/mimics/analysis.py; library half of the reference's
002-wider-saes notebook, contrib/mimics/exps/002-wider-saes/notebook.py:
runs -> L0-vs-NMSE pareto frontier per width -> join per-run mimic task
scores -> does width buy separation?). Runs come from the run dirs + the
offline tracker (the same sources as `tdiscovery.analysis`); scores come from
`scoring.score_run`'s mimic_scores.json artifacts. Host-only: pandas for the
frames and matplotlib for the figure, each imported where used.
"""

import json
import logging
import pathlib

from .. import helpers

logger = logging.getLogger("mimics.analysis")


def _flatten(prefix: str, obj, out: dict) -> None:
    if isinstance(obj, dict):
        for key, value in obj.items():
            _flatten(f"{prefix}/{key}" if prefix else str(key), value, out)
    elif isinstance(obj, (str, int, float, bool)) or obj is None:
        out[prefix] = obj


def load_runs_df(
    runs_root: pathlib.Path,
    *,
    tracker_root: pathlib.Path | None = None,
    tags: tuple[str, ...] = (),
):
    """One row per run: config (width, lr, layer) + tracker eval summary
    (notebook.py:36-82 pulls the same from the wandb API)."""
    pd = helpers.optional_import("pandas", "mimics.analysis")

    rows = []
    for run_dir in sorted(p for p in pathlib.Path(runs_root).iterdir() if p.is_dir()):
        cfg_fpath = run_dir / "checkpoint" / "config.json"
        if not cfg_fpath.exists():
            continue
        cfg = json.loads(cfg_fpath.read_text())
        if tags and not set(tags) & set(cfg.get("tags", [])):
            continue
        row: dict[str, object] = {"run_id": run_dir.name}
        _flatten("config", cfg, row)
        if tracker_root is not None:
            for project_dir in sorted(
                p for p in pathlib.Path(tracker_root).glob("*") if p.is_dir()
            ):
                summary_fpath = project_dir / run_dir.name / "summary.json"
                if summary_fpath.exists():
                    _flatten("summary", json.loads(summary_fpath.read_text()), row)
                    break
        rows.append(row)
    df = pd.DataFrame(rows)
    logger.info("Loaded %d runs from %s.", len(df), runs_root)
    return df


def mark_pareto(
    df,
    *,
    x_col: str = "summary/eval/l0",
    y_col: str = "summary/eval/nmse",
    group_col: str | None = "config/sae/d_sae",
):
    """Flag rows on the lower-left L0/NMSE pareto frontier, per width group
    when `group_col` is given (notebook.py:83-160 plots exactly this
    frontier)."""
    df = df.copy()
    df["pareto"] = False

    def _mark(sub):
        order = sub.sort_values([x_col, y_col]).index
        best = float("inf")
        for idx in order:
            y = sub.at[idx, y_col]
            if y < best:
                df.at[idx, "pareto"] = True
                best = y

    if group_col and group_col in df.columns:
        for _, sub in df.groupby(group_col):
            _mark(sub)
    else:
        _mark(df)
    return df


def join_scores(df, runs_root: pathlib.Path, shard_id: str):
    """Attach each run's best mimic-task separation from mimic_scores.json
    (notebook.py:261-296 reads score parquets the same way)."""
    best_sep, best_task, n_tasks = [], [], []
    for run_id in df["run_id"]:
        fpath = (
            pathlib.Path(runs_root) / run_id / "inference" / shard_id
            / "mimic_scores.json"
        )
        if not fpath.exists():
            best_sep.append(None)
            best_task.append(None)
            n_tasks.append(0)
            continue
        scores = json.loads(fpath.read_text())
        n_tasks.append(len(scores))
        if scores:
            task, entry = max(
                scores.items(), key=lambda kv: kv[1]["best_separation"]
            )
            best_sep.append(entry["best_separation"])
            best_task.append(task)
        else:
            best_sep.append(None)
            best_task.append(None)
    df = df.copy()
    df["best_separation"] = best_sep
    df["best_task"] = best_task
    df["n_tasks"] = n_tasks
    return df


def width_study(df, *, width_col: str = "config/sae/d_sae"):
    """Per width: runs, frontier size, best separation — the notebook's
    headline table (does a wider dictionary buy mimic separation?)."""
    rows = []
    for width, sub in df.groupby(width_col):
        seps = sub["best_separation"].dropna() if "best_separation" in sub else []
        rows.append({
            "d_sae": int(width),
            "n_runs": len(sub),
            "n_pareto": int(sub["pareto"].sum()) if "pareto" in sub else 0,
            "best_separation": float(max(seps)) if len(seps) else None,
            "best_nmse": float(sub["summary/eval/nmse"].min())
            if "summary/eval/nmse" in sub else None,
        })
    pd = helpers.optional_import("pandas", "mimics.analysis")

    return pd.DataFrame(sorted(rows, key=lambda r: r["d_sae"]))


def plot_frontier(df, out_fpath: pathlib.Path, *, width_col: str = "config/sae/d_sae"):
    """L0 vs NMSE scatter, frontier runs highlighted, one color per width
    (notebook.py:95-160)."""
    helpers.optional_import("matplotlib", "mimics.analysis.plot_frontier").use("Agg")
    plt = helpers.optional_import("matplotlib.pyplot", "mimics.analysis.plot_frontier")

    fig, ax = plt.subplots(figsize=(7, 5), layout="constrained")
    for width, sub in df.groupby(width_col):
        ax.scatter(
            sub["summary/eval/l0"], sub["summary/eval/nmse"],
            s=18, alpha=0.45, label=f"d_sae={int(width)}",
        )
        front = sub[sub["pareto"]].sort_values("summary/eval/l0")
        if len(front):
            ax.plot(front["summary/eval/l0"], front["summary/eval/nmse"], lw=1.5)
    ax.set_xlabel("L0")
    ax.set_ylabel("NMSE")
    ax.set_xscale("log")
    ax.legend()
    out_fpath.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_fpath, dpi=120)
    plt.close(fig)
    return out_fpath
