"""Proposal-audit analysis: run dirs -> (sae_df, clf_df) -> hypothesis battery
(counterpart of contrib/trait_discovery/src/tdiscovery/audit_analysis.py;
reference 006_proposal_audit notebook,
`contrib/trait_discovery/notebooks/006_proposal_audit.py:113-3166`). Every
audited run contributes one SAE row (flattened config + eval summary +
pareto flag) and one classifier row per audited head (Yield@B across
budgets, AUC_B, feature count); then a battery of hypothesis tests asks what
drives Yield (layer, classifier type, sparsity, top-k), each as a figure
PLUS the fitted numbers (slope/intercept/R^2, group means), so conclusions
are testable, not just plotted.

As in contrib, rows come from the run dir's own config.json + the offline
tracker, and group-bys are pandas'. Host-only: the frames need pandas, the
figures matplotlib, each imported where used (an ImportError names the
missing package).
"""

import json
import logging
import pathlib

import numpy as np

from .. import disk, helpers
from . import analysis, figplots

logger = logging.getLogger("td.audit")

YIELD_COLS = ("y3", "y10", "y30", "y100")
_BUDGET_BY_COL = {"y3": "3", "y10": "10", "y30": "30", "y100": "100"}


def jitter(n: int, cat_width: float = 0.3, data_width: float = 0.0,
           seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Categorical + value jitter for strip plots (reference 006:55-68)."""
    rng = np.random.default_rng(seed + n)
    return (
        rng.uniform(-cat_width / 2, cat_width / 2, size=n),
        rng.uniform(-data_width / 2, data_width / 2, size=n),
    )


# ---------------------------------------------------------------------------
# Frame assembly (reference 006:113-299 make_dfs_parallel)
# ---------------------------------------------------------------------------


def _cls_header_cfg(ckpt_fpath: pathlib.Path) -> dict:
    """First-line JSON header of a classifier checkpoint, or {}."""
    try:
        with open(ckpt_fpath, "rb") as fd:
            return json.loads(fd.readline()).get("cfg", {})
    except (OSError, json.JSONDecodeError):
        return {}


def _clf_rows_for_run(run: "disk.Run", sae_row: dict) -> list[dict]:
    rows = []
    for shard_dir in sorted(p for p in run.inference.iterdir() if p.is_dir()):
        audit_fpath = shard_dir / "audit_results.json"
        if not audit_fpath.exists():
            continue
        audit = json.loads(audit_fpath.read_text())
        for cls in audit.get("classifiers", []):
            row = dict(sae_row)
            row["shard"] = shard_dir.name
            row["cls/cls_type"] = cls.get("cls_type")
            row["cls/n_nonzero"] = cls.get("n_nonzero_importance")
            row["cls/tau"] = cls.get("tau")
            row["cls/auc_b"] = cls.get("auc_b")
            row["cls/test_acc"] = cls.get("test_acc")
            for col, budget in _BUDGET_BY_COL.items():
                row[f"cls/{col}"] = cls.get("yield_at_b", {}).get(budget)
            header_cfg = _cls_header_cfg(pathlib.Path(cls.get("cls_checkpoint", "")))
            cls_cfg = header_cfg.get("cls", {}) if isinstance(header_cfg, dict) else {}
            row["cls/C"] = cls_cfg.get("C")
            row["cls/max_depth"] = cls_cfg.get("max_depth")
            row["cls/patch_agg"] = header_cfg.get("patch_agg")
            rows.append(row)
    return rows


PARETO_GROUP_COLS = (
    "model_key",
    "config/val_data/layer",
    "data_key",
    "config/sae/activation/key",
)


def _mark_pareto(df, *, x_col: str = "summary/eval/l0",
                 y_col: str = "summary/eval/normalized_mse"):
    """Per-group minimize-L0/minimize-NMSE frontier flag (reference
    006:203-229). Groups lacking the metrics keep is_pareto=False."""
    df = df.copy()
    df["is_pareto"] = False
    if x_col not in df.columns or y_col not in df.columns:
        return df
    group_cols = [c for c in PARETO_GROUP_COLS if c in df.columns]
    groups = df.groupby(group_cols, dropna=False) if group_cols else [(None, df)]
    pareto_ids = set()
    for _, grp in groups:
        grp = grp.dropna(subset=[x_col, y_col]).sort_values([x_col, y_col])
        best = float("inf")
        for run_id, y in zip(grp["run_id"], grp[y_col]):
            if y < best:
                pareto_ids.add(run_id)
                best = y
    df["is_pareto"] = df["run_id"].isin(pareto_ids)
    return df


def load_audit_frames(run_dirs: list[pathlib.Path],
                      tracker_root: pathlib.Path | None = None):
    """(sae_df, clf_df): one row per run / per audited classifier."""
    pd = helpers.optional_import("pandas", "tdiscovery.audit_analysis")

    sae_rows, clf_rows = [], []
    for run_dir in run_dirs:
        try:
            run = disk.Run(pathlib.Path(run_dir))
        except (ValueError, FileNotFoundError) as err:
            logger.info("Skipping %s: %s", run_dir, err)
            continue
        sae_row = analysis.run_record(run, tracker_root)
        sae_rows.append(sae_row)
        clf_rows.extend(_clf_rows_for_run(run, sae_row))

    sae_df = _mark_pareto(pd.DataFrame(sae_rows)) if sae_rows else pd.DataFrame()
    clf_df = pd.DataFrame(clf_rows)
    logger.info("Audit frames: %d runs, %d classifier rows.", len(sae_df), len(clf_df))
    return sae_df, clf_df


def analysis_frame(clf_df):
    """The hypothesis-testing view (reference 006:326-350): one row per
    audited classifier with short column names."""
    pd = helpers.optional_import("pandas", "tdiscovery.audit_analysis")

    if len(clf_df) == 0:
        return pd.DataFrame()
    out = pd.DataFrame({
        "layer": clf_df.get("config/val_data/layer"),
        "top_k": clf_df.get("config/sae/activation/top_k"),
        "clf_type": clf_df.get("cls/cls_type"),
        "C": clf_df.get("cls/C"),
        "max_depth": clf_df.get("cls/max_depth"),
        "n_nonzero": clf_df.get("cls/n_nonzero"),
        "auc_b": clf_df.get("cls/auc_b"),
    })
    for col in YIELD_COLS:
        out[col] = clf_df.get(f"cls/{col}")
    return out.dropna(subset=["auc_b"])


# ---------------------------------------------------------------------------
# Hypothesis battery (reference 006:354-1100 + :1094-2400)
# ---------------------------------------------------------------------------


def _plt():
    helpers.optional_import("matplotlib", "the audit battery's figures").use("Agg")
    return helpers.optional_import("matplotlib.pyplot", "the audit battery's figures")


def _style(ax, axis="y"):
    ax.grid(True, alpha=0.3, axis=axis)
    ax.spines[["right", "top"]].set_visible(False)


def hyp_layer_yield(df, *, metrics=("y3", "y10", "y30")):
    """H1: does layer depth drive Yield@B? Strip plot per layer + linear fit
    per metric. Returns (fig, stats) with stats[metric] = dict(slope,
    intercept, r_squared) and stats['n_per_layer']."""
    plt = _plt()
    layers = sorted(df["layer"].dropna().unique())
    fig, ax = plt.subplots(figsize=(10, 5), dpi=150, layout="constrained")
    colors = {"y3": "C0", "y10": "C1", "y30": "C2"}
    markers = {"y3": "^", "y10": "o", "y30": "s"}
    stats: dict[str, object] = {
        "n_per_layer": {
            int(layer): int((df["layer"] == layer).sum()) for layer in layers
        }
    }
    for j, metric in enumerate(metrics):
        all_xs, all_ys = [], []
        for i, layer in enumerate(layers):
            ys = df[df["layer"] == layer][metric].dropna().to_numpy(dtype=float)
            all_xs.extend([float(layer)] * len(ys))
            all_ys.extend(ys)
            j_cat, j_data = jitter(len(ys))
            ax.scatter(
                i + j_cat + (j - 1) * 0.3, ys + j_data, alpha=0.33,
                c=colors.get(metric, f"C{j}"), marker=markers.get(metric, "o"),
                label=f"Yield@{metric[1:]}" if i == 0 else None, clip_on=False,
            )
        if len(set(all_xs)) > 1:
            slope, intercept = np.polyfit(all_xs, all_ys, 1)
            r_sq = float(np.corrcoef(all_xs, all_ys)[0, 1] ** 2)
            y_fit = slope * np.asarray([layers[0], layers[-1]]) + intercept
            ax.plot([0 + (j - 1) * 0.3, len(layers) - 1 + (j - 1) * 0.3], y_fit,
                    c=colors.get(metric, f"C{j}"), linestyle="--", alpha=0.8)
            stats[metric] = {
                "slope": float(slope), "intercept": float(intercept),
                "r_squared": r_sq,
            }
    ax.set_xticks(range(len(layers)))
    ax.set_xticklabels([f"L{int(layer)}" for layer in layers])
    ax.set_xlabel("Layer")
    ax.set_ylabel("Yield")
    ax.set_ylim(-0.1, 1.1)
    ax.legend()
    _style(ax)
    ax.set_title("Hypothesis 1: Layer effect on Yield")
    return fig, stats


def hyp_clf_type(df, *, metrics=("y3", "y10", "y30")):
    """H2: does classifier type matter? One strip panel per metric.
    Returns (fig, stats) with per-type counts and mean yields."""
    plt = _plt()
    clf_types = sorted(df["clf_type"].dropna().unique())
    fig, axes = plt.subplots(1, len(metrics), figsize=(4 * len(metrics), 4),
                             dpi=150, layout="constrained", squeeze=False)
    stats = {
        "n_per_clf": {c: int((df["clf_type"] == c).sum()) for c in clf_types},
        "mean_yield": {},
    }
    for ax, metric in zip(axes[0], metrics):
        means = {}
        for i, clf in enumerate(clf_types):
            ys = df[df["clf_type"] == clf][metric].dropna().to_numpy(dtype=float)
            j_cat, _ = jitter(len(ys))
            ax.scatter(i + j_cat, ys, alpha=0.5, s=15, clip_on=False)
            means[clf] = float(ys.mean()) if len(ys) else float("nan")
        stats["mean_yield"][metric] = means
        ax.set_xticks(range(len(clf_types)))
        ax.set_xticklabels(clf_types, rotation=15, ha="right")
        ax.set_ylabel(f"Yield@{metric[1:]}")
        ax.set_ylim(-0.1, 1.1)
        _style(ax)
    fig.suptitle("Hypothesis 2: Classifier type effect")
    return fig, stats


def hyp_nonzero_yield(df, *, metrics=("y3", "y10", "y30")):
    """H3: feature-count vs Yield — scatter on log-x with correlation and a
    log-linear fit per metric. Returns (fig, stats[metric] = dict(r, slope,
    intercept))."""
    plt = _plt()
    sub = df.dropna(subset=["n_nonzero"])
    xs = sub["n_nonzero"].to_numpy(dtype=float)
    xs = np.maximum(xs, 1.0)
    log_xs = np.log10(xs)
    fig, axes = plt.subplots(1, len(metrics), figsize=(4 * len(metrics), 4),
                             dpi=150, layout="constrained", squeeze=False)
    stats = {}
    x_fit = np.geomspace(xs.min(), xs.max(), 100) if len(xs) else np.array([1.0])
    for ax, metric in zip(axes[0], metrics):
        ys = sub[metric].to_numpy(dtype=float)
        r = float(np.corrcoef(xs, ys)[0, 1]) if len(xs) > 1 else float("nan")
        ax.scatter(xs, ys, alpha=0.5, s=20, clip_on=False)
        if len(xs) > 1:
            slope, intercept = np.polyfit(log_xs, ys, 1)
            ax.plot(x_fit, slope * np.log10(x_fit) + intercept, "r--",
                    alpha=0.7, label="fit")
            stats[metric] = {
                "r": r, "slope": float(slope), "intercept": float(intercept)
            }
        ax.set_xscale("log")
        ax.set_xlabel("# Non-zero Features")
        ax.set_ylabel(f"Yield@{metric[1:]}")
        ax.set_ylim(-0.1, 1.1)
        ax.set_title(f"r = {r:.3f}")
        _style(ax, axis="both")
    fig.suptitle("Hypothesis 3: n_nonzero vs Yield")
    return fig, stats


def hyp_layer_clf_interaction(df, *, metrics=("y10", "y30")):
    """H4: layer x classifier interaction — mean yield lines per type.
    Returns (fig, the aggregated table)."""
    plt = _plt()
    agg = (
        df.dropna(subset=["layer", "clf_type"])
        .groupby(["layer", "clf_type"])[list(metrics)]
        .mean()
        .reset_index()
        .sort_values(["layer", "clf_type"])
    )
    fig, axes = plt.subplots(1, len(metrics), figsize=(5 * len(metrics), 4),
                             dpi=150, layout="constrained", squeeze=False)
    for ax, metric in zip(axes[0], metrics):
        for clf_type, marker in (("decision-tree", "^"), ("sparse-linear", "o")):
            sub = agg[agg["clf_type"] == clf_type]
            if len(sub) == 0:
                continue
            ax.plot(sub["layer"], sub[metric], marker=marker, label=clf_type)
        ax.set_xlabel("Layer")
        ax.set_ylabel(f"Yield@{metric[1:]}")
        ax.set_ylim(0, 1)
        ax.legend()
        _style(ax, axis="both")
    fig.suptitle("Hypothesis 4: Layer x Classifier interaction")
    return fig, agg


def hyp_topk_yield(df, *, metric: str = "y10"):
    """H5: SAE top-k effect per classifier type (strip plot). Returns
    (fig, per-(top_k, clf_type) mean table)."""
    plt = _plt()
    sub = df.dropna(subset=["top_k"])
    ks = sorted(sub["top_k"].unique())
    clf_types = sorted(sub["clf_type"].dropna().unique())
    fig, ax = plt.subplots(figsize=(8, 4), dpi=150, layout="constrained")
    for j, clf in enumerate(clf_types):
        for i, k in enumerate(ks):
            ys = sub[(sub["top_k"] == k) & (sub["clf_type"] == clf)][metric]
            ys = ys.dropna().to_numpy(dtype=float)
            j_cat, _ = jitter(len(ys))
            ax.scatter(i + j_cat + (j - 0.5) * 0.3, ys, alpha=0.5, s=15,
                       label=clf if i == 0 else None, c=f"C{j}", clip_on=False)
    ax.set_xticks(range(len(ks)))
    ax.set_xticklabels([str(int(k)) for k in ks])
    ax.set_xlabel("SAE top-k")
    ax.set_ylabel(f"Yield@{metric[1:]}")
    ax.set_ylim(-0.1, 1.1)
    ax.legend()
    _style(ax)
    ax.set_title("Hypothesis 5: top_k effect by classifier type")
    agg = (
        sub.groupby(["top_k", "clf_type"])[metric].mean().reset_index()
    )
    return fig, agg


def hyp_best_configs(df, *, metric: str = "y10", n: int = 10):
    """H8: which configurations maximize Yield@10? Top-n table."""
    cols = [c for c in ("layer", "top_k", "clf_type", "C", "max_depth",
                        "n_nonzero", metric, "auc_b") if c in df.columns]
    return df.dropna(subset=[metric]).nlargest(n, metric)[cols].reset_index(
        drop=True
    )


def hyp_corr_heatmap(df):
    """H9: correlation matrix over the numeric hypothesis columns.
    Returns (fig, corr DataFrame)."""
    plt = _plt()
    numeric = df[[c for c in ("layer", "top_k", "n_nonzero", "auc_b",
                              *YIELD_COLS) if c in df.columns]]
    numeric = numeric.dropna(axis=1, how="all").astype(float)
    corr = numeric.corr()
    fig, ax = plt.subplots(figsize=(6, 5), dpi=150, layout="constrained")
    im = ax.imshow(corr.to_numpy(), vmin=-1, vmax=1, cmap="RdBu_r")
    ax.set_xticks(range(len(corr.columns)))
    ax.set_xticklabels(corr.columns, rotation=45, ha="right")
    ax.set_yticks(range(len(corr.columns)))
    ax.set_yticklabels(corr.columns)
    for i in range(len(corr)):
        for j in range(len(corr)):
            ax.text(j, i, f"{corr.iloc[i, j]:.2f}", ha="center", va="center",
                    fontsize=7)
    fig.colorbar(im, ax=ax, shrink=0.8)
    ax.set_title("Hypothesis 9: Correlation heatmap")
    return fig, corr


def fig_auc_over_yield(clf_df):
    """Feature grounding: mean Yield@B per budget per classifier type, the
    curve whose area is AUC_B (reference 006:1295-1390). Returns
    (fig, table)."""
    pd = helpers.optional_import("pandas", "tdiscovery.audit_analysis")

    plt = _plt()
    rows = []
    for _, row in clf_df.iterrows():
        for col, budget in _BUDGET_BY_COL.items():
            val = row.get(f"cls/{col}")
            if val is not None and not (isinstance(val, float) and np.isnan(val)):
                rows.append({
                    "clf_type": row.get("cls/cls_type"),
                    "budget": int(budget),
                    "yield": float(val),
                })
    tall = pd.DataFrame(rows)
    fig, ax = plt.subplots(figsize=(5, 4), dpi=150, layout="constrained")
    if len(tall):
        agg = tall.groupby(["clf_type", "budget"])["yield"].mean().reset_index()
        for clf_type, sub in agg.groupby("clf_type"):
            sub = sub.sort_values("budget")
            ax.plot(sub["budget"], sub["yield"], marker="o", label=str(clf_type))
    else:
        agg = tall
    ax.set_xscale("log")
    ax.set_xlabel("Budget B")
    ax.set_ylabel("Yield@B")
    ax.set_ylim(0, 1)
    ax.legend()
    _style(ax, axis="both")
    ax.set_title("Feature Grounding (AUC over Yield@B)")
    return fig, agg


def fig_pareto_frontiers(
    sae_df,
    *,
    x_col: str = "summary/eval/l0",
    y_col: str = "summary/eval/normalized_mse",
    layer_col: str = "config/val_data/layer",
    layers: list[int] | None = None,
    filters: dict | None = None,
):
    """Per-layer L0/NMSE pareto frontiers on log-log axes (reference
    005_bufferflies.py :388-459 / 007_cambridge_sae.py :406-543: filter to
    one activation/data config, plot each layer's `is_pareto` runs as a
    line). Returns (fig, {layer: [pareto run ids]})."""
    plt = _plt()
    df = sae_df
    for col, want in (filters or {}).items():
        if col not in df.columns:
            # A missing filter column must empty the selection, not silently
            # include every run in a figure labeled as filtered.
            logger.warning(
                "fig_pareto_frontiers: filter column %r absent; no runs match.",
                col,
            )
            df = df.iloc[0:0]
            break
        df = df[df[col] == want]
    have_metrics = {x_col, y_col, layer_col, "is_pareto"} <= set(df.columns)
    if not have_metrics and len(df):
        logger.warning(
            "fig_pareto_frontiers: metric columns missing (no tracker?); "
            "emitting an empty frontier plot."
        )
        df = df.iloc[0:0]
    if layers is None:
        layers = sorted(
            int(v) for v in df[layer_col].dropna().unique()
        ) if layer_col in df.columns else []

    fig, ax = plt.subplots(figsize=(5, 4), dpi=150, layout="constrained")
    markers = ("o", "^", "s", "x", "+", "d", "v")
    pareto_ckpts: dict[int, list[str]] = {}
    for i, layer in enumerate(layers):
        group = df[(df[layer_col] == layer) & df["is_pareto"]]
        group = group.dropna(subset=[x_col, y_col]).sort_values(x_col)
        if not len(group):
            continue
        ax.plot(
            group[x_col], group[y_col], alpha=0.6, marker=markers[i % len(markers)],
            label=f"Layer {int(layer) + 1}",
        )
        pareto_ckpts[int(layer)] = list(group["run_id"])
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("L$_0$ ($\\downarrow$)")
    ax.set_ylabel("Normalized MSE ($\\downarrow$)")
    if pareto_ckpts:
        ax.legend(fontsize=8)
    _style(ax, axis="both")
    return fig, pareto_ckpts


def fig_sparsity_accuracy(clf_df, *, x_col: str = "cls/n_nonzero",
                          y_col: str = "cls/test_acc"):
    """Classifier sparsity/accuracy tradeoff: features-used vs test accuracy
    per head type (reference 005_bufferflies.py :477-557). Returns
    (fig, per-type best table)."""
    pd = helpers.optional_import("pandas", "tdiscovery.audit_analysis")

    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4), dpi=150, layout="constrained")
    sub = clf_df.dropna(subset=[c for c in (x_col, y_col) if c in clf_df.columns])
    rows = []
    for clf_type, grp in sub.groupby("cls/cls_type"):
        ax.scatter(grp[x_col], grp[y_col], alpha=0.5, label=str(clf_type), s=14)
        best = grp.loc[grp[y_col].idxmax()]
        rows.append({
            "clf_type": clf_type,
            "best_acc": float(best[y_col]),
            "n_nonzero": float(best[x_col]),
        })
    ax.set_xscale("log")
    ax.set_xlabel("features used (n_nonzero)")
    ax.set_ylabel("test accuracy")
    if rows:
        ax.legend(fontsize=8)
    _style(ax, axis="both")
    return fig, pd.DataFrame(rows)


def run_battery(run_dirs: list[pathlib.Path], out: pathlib.Path,
                tracker_root: pathlib.Path | None = None) -> dict:
    """Assemble frames, run every hypothesis, save figures + stats JSON.
    Returns {name: stats} for programmatic use."""
    sae_df, clf_df = load_audit_frames(run_dirs, tracker_root)
    adf = analysis_frame(clf_df)
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    results: dict[str, object] = {"n_runs": len(sae_df), "n_clf": len(adf)}
    if len(adf) == 0:
        (out / "audit_stats.json").write_text(json.dumps(results, indent=2))
        return results

    figures = {}
    fig, stats = hyp_layer_yield(adf)
    figures["h1_layer_yield"], results["h1_layer_yield"] = fig, stats
    fig, stats = hyp_clf_type(adf)
    figures["h2_clf_type"], results["h2_clf_type"] = fig, stats
    fig, stats = hyp_nonzero_yield(adf)
    figures["h3_nonzero"], results["h3_nonzero"] = fig, stats
    fig, table = hyp_layer_clf_interaction(adf)
    figures["h4_interaction"] = fig
    results["h4_interaction"] = table.to_dict("records")
    fig, table = hyp_topk_yield(adf)
    figures["h5_topk"] = fig
    results["h5_topk"] = table.to_dict("records")
    results["h8_best_configs"] = hyp_best_configs(adf).to_dict("records")
    fig, corr = hyp_corr_heatmap(adf)
    figures["h9_corr"] = fig
    results["h9_corr"] = corr.round(4).to_dict()
    fig, agg = fig_auc_over_yield(clf_df)
    figures["auc_over_yield"] = fig
    results["auc_over_yield"] = (
        agg.to_dict("records") if hasattr(agg, "to_dict") else []
    )

    figplots.save_battery(figures, {}, out)
    (out / "audit_stats.json").write_text(
        json.dumps(results, indent=2, default=str)
    )
    logger.info("Audit battery: %d figures -> %s", len(figures), out)
    return results

