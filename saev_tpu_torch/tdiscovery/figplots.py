"""Figure and table battery for the trait-discovery paper artifacts
(counterpart of contrib/trait_discovery/src/tdiscovery/figplots.py).

Capability port of the reference's figure notebooks
(`contrib/trait_discovery/notebooks/figures.py:356-2462` and
`notebooks/metrics.py:344-1400`). The reference builds each figure as a
stand-alone 150-line cell; the repeated structure (per-layer panel grids,
pareto emphasis, method-comparison tables) is factored here into three
engines — `layerwise_grid`, `fig_tradeoff`, `comparison_table` — plus thin
named wrappers matching the reference's figure list, so every figure stays
one call and the styling/semantics live in one place.

All functions take the validated DataFrame from
`tdiscovery.analysis.load_probe_results_df` (or `tdiscovery.runs.load_df`
for run-artifact tables) and RETURN the matplotlib Figure plus the plotted
sub-frame, so tests assert content, not just "it rendered".
"""

import dataclasses
import pathlib

import numpy as np

from .. import helpers
from . import runs as td_runs

__all__ = [
    "fig_overfitting",
    "layerwise_grid",
    "fig_layerwise_explained_variance",
    "fig_layerwise_log_l0",
    "fig_layerwise_map",
    "fig_layerwise_probe_r",
    "fig_layerwise_purity",
    "fig_layerwise_cov",
    "fig_tradeoff",
    "fig_prevalence_vs_ap",
    "fig_latent_vs_purity",
    "comparison_table",
    "table_sae_vs_baselines",
    "table_vit_size",
    "table_vit_family",
    "table_sae_variants",
]


def _plt():
    helpers.optional_import("matplotlib", "tdiscovery.figplots").use("Agg")
    return helpers.optional_import("matplotlib.pyplot", "tdiscovery.figplots")


def _style(ax, *, grid_axis: str = "both") -> None:
    """House style shared by every panel (reference notebooks: thin grid,
    no top/right spines)."""
    ax.grid(True, linewidth=0.3, alpha=0.5, axis=grid_axis)
    ax.spines[["right", "top"]].set_visible(False)


# ---------------------------------------------------------------------------
# Overfitting diagnostic (reference notebooks/metrics.py:352-450)
# ---------------------------------------------------------------------------


def fig_overfitting(df, *, model: str | None = None):
    """Two panels: train-vs-val probe CE and train-vs-val probe R, with the
    overfitting half-plane shaded. Returns (fig, sub_df)."""
    plt = _plt()
    sub = df if model is None else df[df["model"] == model]
    if not len(sub):
        raise ValueError(
            f"fig_overfitting: no rows for model={model!r} "
            f"(have {sorted(df['model'].unique()) if len(df) else []})"
        )
    fig, (ax_ce, ax_r) = plt.subplots(
        ncols=2, dpi=200, figsize=(8, 3), layout="constrained"
    )

    tr_ce = sub["train_probe_ce"].to_numpy()
    va_ce = sub["val_probe_ce"].to_numpy()
    tr_base = sub["train_baseline_ce"].to_numpy()
    va_base = sub["val_baseline_ce"].to_numpy()
    lo = min(tr_ce.min(), va_ce.min(), tr_base.min(), va_base.min())
    hi = max(tr_ce.max(), va_ce.max(), tr_base.max(), va_base.max())
    ax_ce.plot([lo, hi], [lo, hi], color="tab:red", alpha=0.1)
    ax_ce.fill_between(
        [lo, hi], [hi, hi], [lo, hi], alpha=0.3, color="tab:red",
        linewidth=0, label="Overfitting",
    )
    ax_ce.scatter(tr_ce, va_ce, label="Probe CE", alpha=0.5)
    # One marker per DISTINCT baseline: mixed shards/datasets carry different
    # prevalence floors, and a single arbitrary row's baseline would mislabel
    # the rest.
    bases = np.unique(np.stack([tr_base, va_base], axis=1), axis=0)
    ax_ce.scatter(bases[:, 0], bases[:, 1], label="Baseline CE", alpha=0.5)
    _style(ax_ce)
    ax_ce.set_xlabel("Train CE ($\\downarrow$)")
    ax_ce.set_ylabel("Val CE ($\\downarrow$)")
    ax_ce.legend()

    xs = sub["train_probe_r"].to_numpy()
    ys = sub["val_probe_r"].to_numpy()
    lo_r, hi_r = min(xs.min(), ys.min()), max(xs.max(), ys.max())
    ax_r.plot([lo_r, hi_r], [lo_r, hi_r], color="tab:red", alpha=0.1)
    ax_r.fill_between(
        [lo_r, hi_r], [lo_r, lo_r], [lo_r, hi_r], alpha=0.3, color="tab:red",
        linewidth=0, label="Overfitting",
    )
    ax_r.scatter(xs, ys, label="Probe R", alpha=0.5)
    _style(ax_r)
    ax_r.set_xlabel("Train R ($\\uparrow$)")
    ax_r.set_ylabel("Val R ($\\uparrow$)")
    ax_r.legend()
    fig.suptitle("Measuring Overfitting")
    return fig, sub


# ---------------------------------------------------------------------------
# Layerwise panel grids — ONE engine behind the reference's six near-copies
# (explained variance, log-L0, mAP, probe R, purity, coverage:
# reference notebooks/metrics.py:466-700, 820-1260 and figures.py:1033-1690)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerwiseSpec:
    """Axis recipe for one layerwise grid variant."""

    x: str
    y: str
    xlabel: str
    ylabel: str
    xscale: str = "linear"
    xlim: tuple | None = None
    ylim: tuple | None = None
    transform_x: str | None = None  # None | "explained_variance"


def layerwise_grid(df, spec: LayerwiseSpec, *, model: str, layers: list[int],
                   n_layers: int, title: str | None = None):
    """One scatter panel per layer for a single backbone. Returns
    (fig, {layer: (xs, ys)})."""
    plt = _plt()
    fig, axes = plt.subplots(
        nrows=1, ncols=max(len(layers), 1), dpi=300,
        figsize=(2 * max(len(layers), 1), 2.4),
        layout="constrained", sharex=True, sharey=True, squeeze=False,
    )
    plotted: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for i, (layer, ax) in enumerate(zip(layers, axes[0])):
        sub = df[(df["model"] == model) & (df["layer"] == layer)]
        xs = sub[spec.x].to_numpy(dtype=float)
        if spec.transform_x == "explained_variance":
            xs = 1.0 - xs
        ys = sub[spec.y].to_numpy(dtype=float)
        plotted[layer] = (xs, ys)
        ax.scatter(xs, ys, color="tab:blue", alpha=0.8, zorder=3, clip_on=False)
        ax.set_title(f"Layer {layer + 1}/{n_layers}")
        _style(ax)
        ax.set_xscale(spec.xscale)
        ax.set_xlabel(spec.xlabel)
        if i == 0:
            ax.set_ylabel(spec.ylabel)
        if spec.xlim:
            ax.set_xlim(*spec.xlim)
        if spec.ylim:
            ax.set_ylim(*spec.ylim)
    fig.suptitle(title or model)
    return fig, plotted


def fig_layerwise_explained_variance(df, **kw):
    return layerwise_grid(df, LayerwiseSpec(
        x="val_nmse", y="val_probe_r", transform_x="explained_variance",
        xlabel="Explained Variance", ylabel="Val Probe R ($\\uparrow$)",
        xlim=(0, 1.0),
    ), **kw)


def fig_layerwise_log_l0(df, **kw):
    return layerwise_grid(df, LayerwiseSpec(
        x="sae_val_l0", y="val_probe_r", xscale="log",
        xlabel="L0", ylabel="Val Probe R ($\\uparrow$)",
    ), **kw)


def fig_layerwise_map(df, **kw):
    return layerwise_grid(df, LayerwiseSpec(
        x="sae_val_l0", y="val_mean_ap", xscale="log",
        xlabel="L0", ylabel="Val mAP ($\\uparrow$)", ylim=(0, 1),
    ), **kw)


def fig_layerwise_probe_r(df, **kw):
    return layerwise_grid(df, LayerwiseSpec(
        x="sae_val_l0", y="val_probe_r", xscale="log",
        xlabel="L0", ylabel="Val Probe R ($\\uparrow$)",
    ), **kw)


def fig_layerwise_purity(df, **kw):
    return layerwise_grid(df, LayerwiseSpec(
        x="sae_val_l0", y="val_mean_purity_16", xscale="log",
        xlabel="L0", ylabel="Purity@16 ($\\uparrow$)", ylim=(0, 1),
    ), **kw)


def fig_layerwise_cov(df, *, tau: str = "0_5", **kw):
    return layerwise_grid(df, LayerwiseSpec(
        x="sae_val_l0", y=f"cov_at_{tau}", xscale="log",
        xlabel="L0", ylabel=f"Coverage@{tau.replace('_', '.')} ($\\uparrow$)",
        ylim=(0, 1),
    ), **kw)


# ---------------------------------------------------------------------------
# Tradeoff / pareto figure (reference figures.py:356-1030)
# ---------------------------------------------------------------------------


def fig_tradeoff(df, *, x: str = "sae_val_l0", y: str = "val_nmse",
                 group: str = "model", xscale: str = "log",
                 xlabel: str = "L0", ylabel: str = "Normalized MSE",
                 annotate_pareto: bool = True):
    """Per-group scatter of the (x, y) tradeoff with the minimize-minimize
    pareto frontier drawn per group. Returns (fig, {group: frontier_mask})."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4), dpi=200, layout="constrained")
    frontiers = {}
    sub = df.dropna(subset=[x, y])
    for name, grp in sub.groupby(group):
        xs = grp[x].to_numpy(dtype=float)
        ys = grp[y].to_numpy(dtype=float)
        ax.scatter(xs, ys, label=str(name), alpha=0.6, s=24)
        mask = td_runs.pareto_front(xs, ys)
        frontiers[name] = mask
        order = np.argsort(xs[mask])
        ax.plot(xs[mask][order], ys[mask][order], alpha=0.5)
        if annotate_pareto:
            for run_id, px, py in zip(
                grp["run_id"].to_numpy()[mask], xs[mask], ys[mask]
            ):
                ax.annotate(str(run_id), (px, py), fontsize=5, alpha=0.7)
    ax.set_xscale(xscale)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    _style(ax)
    ax.legend(fontsize=7)
    return fig, frontiers


# ---------------------------------------------------------------------------
# Per-class / per-latent diagnostics (reference notebooks/metrics.py
# prevalence + latent-purity cells)
# ---------------------------------------------------------------------------


def fig_prevalence_vs_ap(shards_dir: pathlib.Path, ap_c: np.ndarray):
    """Class prevalence (log) vs per-class AP — is the probe just finding
    frequent classes? Returns (fig, (prevalence, ap))."""
    from .analysis import baseline_ce  # local import to avoid cycle

    plt = _plt()
    md_ce = baseline_ce(pathlib.Path(shards_dir))
    n = min(len(md_ce), len(ap_c))
    prevalence = np.asarray(md_ce[:n])
    ap = np.asarray(ap_c[:n])
    fig, ax = plt.subplots(figsize=(4, 3), dpi=200, layout="constrained")
    ax.scatter(prevalence, ap, alpha=0.6, s=16)
    ax.set_xlabel("Class prevalence entropy (baseline CE)")
    ax.set_ylabel("Per-class AP")
    ax.set_ylim(0, 1)
    _style(ax)
    return fig, (prevalence, ap)


def fig_latent_vs_purity(run_dir: pathlib.Path, train_shard: str,
                         val_shard: str, *, k: int = 16):
    """Best-latent probe loss vs purity@k per class (reference
    notebooks/metrics.py plot_latent_vs_purity). Reads the run's own probe
    artifacts. Returns (fig, (loss_c, purity_c))."""
    from .analysis import mode  # local import to avoid cycle

    plt = _plt()
    run_dir = pathlib.Path(run_dir)
    with np.load(run_dir / "inference" / train_shard / "probe1d_metrics.npz") as fd:
        train_loss = fd["loss"]
    ap_fpath = run_dir / "inference" / val_shard / (
        f"probe1d_metrics__train-{train_shard}.npz"
    )
    with np.load(ap_fpath) as fd:
        top_labels = fd["top_labels"]

    best_i = np.argmin(train_loss, axis=0)
    cols = np.arange(train_loss.shape[1])
    loss_c = train_loss[best_i, cols]
    _, count = mode(top_labels[best_i, :k], axis=1)
    purity_c = count / k

    fig, ax = plt.subplots(figsize=(4, 3), dpi=200, layout="constrained")
    ax.scatter(loss_c, purity_c, alpha=0.6, s=16)
    ax.set_xlabel("Best-latent train probe loss ($\\downarrow$)")
    ax.set_ylabel(f"Purity@{k} ($\\uparrow$)")
    ax.set_ylim(0, 1.02)
    _style(ax)
    return fig, (loss_c, purity_c)


# ---------------------------------------------------------------------------
# Method-comparison tables — ONE engine behind the reference's five
# near-identical table cells (figures.py:1730-2462: sae_vs_baselines,
# vit_size, vit_family, sae_variants, ade20k_vs_fishvista)
# ---------------------------------------------------------------------------

DEFAULT_TABLE_COLUMNS = (
    ("L0", "sae_val_l0"),
    ("NMSE", "val_nmse"),
    ("Probe R", "val_probe_r"),
    ("mAP", "val_mean_ap"),
    ("Cov@0.5", "cov_at_0_5"),
    ("Purity@16", "val_mean_purity_16"),
)


def comparison_table(df, row_specs: list[tuple[str, dict]], *,
                     columns=DEFAULT_TABLE_COLUMNS,
                     pick: str = "val_mean_ap"):
    """One table row per (label, filters): filter the df, take the run
    maximizing `pick`, and report the named columns. Missing methods get a
    null row (the reference's make_null_row) so tables stay aligned across
    incomplete sweeps. Returns a DataFrame."""
    pd = helpers.optional_import("pandas", "tdiscovery.figplots")

    rows = []
    for label, filters in row_specs:
        sub = df
        for col, val in filters.items():
            sub = sub[sub[col] == val]
        if len(sub) == 0 or pick not in sub or sub[pick].isna().all():
            rows.append({"method": label, "run_id": None,
                         **{name: None for name, _ in columns}})
            continue
        best = sub.loc[sub[pick].idxmax()]
        rows.append({
            "method": label,
            "run_id": best["run_id"],
            **{
                name: (float(best[col]) if col in best and best[col] is not None
                       and not (isinstance(best[col], float) and np.isnan(best[col]))
                       else None)
                for name, col in columns
            },
        })
    return pd.DataFrame(rows)


def table_sae_vs_baselines(df, *, models: list[str] | None = None):
    """Best SAE per backbone vs any baseline methods present in the df
    (reference figures.py:1730-1910)."""
    models = models or sorted(df["model"].dropna().unique())
    return comparison_table(df, [(m, {"model": m}) for m in models])


def table_vit_size(df, *, family_order=("ViT-S", "ViT-B", "ViT-L")):
    """Best run per ViT size class (reference figures.py:1913-2056)."""
    specs = []
    for size in family_order:
        match = [m for m in df["model"].dropna().unique() if size in m]
        for m in match:
            specs.append((m, {"model": m}))
    return comparison_table(df, specs)


def table_vit_family(df):
    """Best run per backbone family prefix (reference figures.py:2059-2170)."""
    fams = sorted({str(m).split(" ")[0] for m in df["model"].dropna().unique()})
    specs = []
    for fam in fams:
        match = [m for m in df["model"].dropna().unique() if str(m).startswith(fam)]
        best_models = [(m, {"model": m}) for m in match]
        specs.extend(best_models)
    return comparison_table(df, specs)


def table_sae_variants(df, *, key: str = "objective"):
    """Best run per SAE variant (vanilla vs matryoshka by default;
    reference figures.py:2173-2357)."""
    variants = sorted(df[key].dropna().unique())
    return comparison_table(df, [(str(v), {key: v}) for v in variants])


def save_battery(figures: dict[str, object], tables: dict[str, object],
                 out: pathlib.Path) -> list[pathlib.Path]:
    """Persist a battery: each figure as pdf, each table as csv + markdown
    (the reference saves every artifact cell-by-cell; one loop here)."""
    if tables:
        helpers.optional_import("tabulate", "tdiscovery.figplots.save_battery's markdown tables")
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, fig in figures.items():
        fpath = out / f"{name}.pdf"
        fig.savefig(fpath, bbox_inches="tight")
        written.append(fpath)
    for name, tdf in tables.items():
        fpath = out / f"{name}.csv"
        tdf.to_csv(fpath, index=False)
        (out / f"{name}.md").write_text(tdf.to_markdown(index=False))
        written.append(fpath)
    return written
