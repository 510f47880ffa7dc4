"""Variant-ablation analysis: sweep completeness, dead units, probe winners
(counterpart of contrib/trait_discovery/src/tdiscovery/ablations.py).

Capability port of the reference's 003_auxk notebook (and the matching cells
of 002_optim / 001_actfn; `contrib/trait_discovery/notebooks/003_auxk.py:
388-911`): given the flattened per-run frame from
`tdiscovery.audit_analysis.load_audit_frames` (columns `config/...`,
`summary/...`, `model_key`, `data_key`, `is_pareto`), answer the study's
actual questions —

- is the sweep complete per (variant x data x layer) cell?  (`completeness`)
- does the variant change dead-unit counts on the pareto set?  (`dead_units`)
- which run per group wins on downstream probe quality?  (`best_by`)
- how do the variants' L0/NMSE pareto fronts compare per panel?
  (`fig_variant_grid`)
- how does source NMSE relate to downstream NMSE/probe quality at one layer?
  (`source_vs_downstream`)

Everything returns (rows, ...) lists/figures whose CONTENT tests can assert,
not just render.
"""

import logging

import numpy as np

from .. import helpers
from . import runs as td_runs

logger = logging.getLogger("td.ablations")

VARIANT_COL = "config/sae/activation/aux/key"
X_COL = "summary/eval/l0"
Y_COL = "summary/eval/normalized_mse"
GROUP_COLS = (VARIANT_COL, "data_key", "config/val_data/layer")


def _grouped(df, cols):
    if not len(df):
        # An empty sweep (no runs loaded) yields zero groups, not a
        # misleading missing-columns assertion (load_audit_frames returns a
        # column-less frame when nothing loads).
        return []
    present = [c for c in cols if c in df.columns]
    assert len(present) == len(cols), (
        f"Frame is missing group columns {sorted(set(cols) - set(present))}"
    )
    return df.groupby(list(cols), dropna=False)


def _variant_pareto(df, *, variant_col: str = VARIANT_COL,
                    match_cols=("data_key", "config/val_data/layer")):
    """Rows on their OWN variant's L0/NMSE front within each (data, layer)
    panel. The frame's global `is_pareto` pools variants per activation key
    (audit_analysis.PARETO_GROUP_COLS), so a dominated variant would vanish
    from exactly the variant comparison this module makes; per-variant fronts
    keep both sides comparable."""
    if not len(df):
        return df
    keep = np.zeros(len(df), dtype=bool)
    cols = [c for c in (*match_cols, variant_col) if c in df.columns]
    for _, grp in df.groupby(cols, dropna=False):
        grp = grp[grp[X_COL].notna() & grp[Y_COL].notna()]
        if not len(grp):
            continue
        grp = grp.sort_values(X_COL)
        mask = td_runs.pareto_front(
            grp[X_COL].to_numpy(dtype=float), grp[Y_COL].to_numpy(dtype=float)
        )
        keep[df.index.get_indexer(grp.index[mask])] = True
    return df[keep]


def completeness(df, *, group_cols=GROUP_COLS, expected: int):
    """Per-(variant, data, layer) run counts vs the sweep design size
    (reference 003:388-404: `expected = 3 * 5` lr x sparsity points)."""
    rows = []
    for keys, grp in _grouped(df, group_cols):
        keys = keys if isinstance(keys, tuple) else (keys,)
        rows.append({
            **dict(zip(group_cols, keys)),
            "count": len(grp),
            "expected": expected,
            "done": len(grp) == expected,
        })
    return sorted(rows, key=lambda r: tuple(str(r[c]) for c in group_cols))


def dead_units(df, *, group_cols=GROUP_COLS, pareto_only: bool = True):
    """Mean/std dead-latent percentage per group — train-end (`loss/n_dead`)
    and eval (`eval/n_dead`), both normalized by d_sae (reference
    003:680-725). AuxK's entire job is driving these numbers down.
    `pareto_only` keeps each VARIANT's own front (see _variant_pareto)."""
    sub = _variant_pareto(df) if pareto_only else df
    rows = []
    for keys, grp in _grouped(sub, group_cols):
        keys = keys if isinstance(keys, tuple) else (keys,)
        d_sae = grp["config/sae/d_sae"].astype(float)
        row = {**dict(zip(group_cols, keys)), "n_trials": len(grp)}
        for label, col in (("loss", "summary/loss/n_dead"),
                           ("eval", "summary/eval/n_dead")):
            if col in grp.columns:
                pct = grp[col].astype(float) / d_sae * 100
                row[f"{label}_mean"] = float(pct.mean())
                row[f"{label}_std"] = float(pct.std())
            else:
                row[f"{label}_mean"] = row[f"{label}_std"] = float("nan")
        rows.append(row)
    return sorted(rows, key=lambda r: tuple(str(r[c]) for c in group_cols))


def best_by(df, metric: str, *, group_cols=GROUP_COLS, pareto_only: bool = True,
            display=("run_id", X_COL, Y_COL)):
    """The winning run per group by `metric` (reference 003:729-775 "Probe
    Results": best train_probe_r per (data, layer, aux)). `pareto_only`
    keeps each VARIANT's own front (see _variant_pareto)."""
    sub = _variant_pareto(df) if pareto_only else df
    sub = sub[sub[metric].notna()]
    rows = []
    for keys, grp in _grouped(sub, group_cols):
        keys = keys if isinstance(keys, tuple) else (keys,)
        winner = grp.loc[grp[metric].astype(float).idxmax()]
        row = {**dict(zip(group_cols, keys)), metric: float(winner[metric])}
        for col in display:
            if col in grp.columns:
                row[col] = winner[col]
        rows.append(row)
    return sorted(rows, key=lambda r: tuple(str(r[c]) for c in group_cols))


def source_vs_downstream(df, *, layer: int,
                         downstream_cols=("train_probe_r", "val_probe_r")):
    """One layer's runs with source-reconstruction and downstream columns side
    by side, sorted by L0 (reference 003:408-437 "Layer 24 NMSE"). The
    question: does better source NMSE buy better downstream probes?"""
    layers = df["config/val_data/layer"]
    sub = df[layers.notna() & (layers.astype(float) == float(layer))]
    sub = sub[sub[Y_COL].notna()]
    cols = ["run_id", "data_key", VARIANT_COL, X_COL, Y_COL]
    cols += [c for c in downstream_cols if c in sub.columns]
    if "is_pareto" in sub.columns:
        cols.append("is_pareto")
    out = sub[cols].sort_values(["data_key", VARIANT_COL, X_COL])
    return out.to_dict("records")


def fig_variant_grid(df, *, variant_col: str = VARIANT_COL,
                     panel_rows: str = "data_key",
                     panel_cols: str = "config/val_data/layer",
                     x: str = X_COL, y: str = Y_COL,
                     pareto_only: bool = True):
    """Pareto-front overlay per variant, one panel per (data, layer)
    (reference 003:440-619's 4x3 grid). Returns (fig, pareto_run_ids) where
    pareto_run_ids[(row, col)] lists the plotted frontier runs — the
    checkpoints the notebook then feeds to visuals."""
    helpers.optional_import("matplotlib", "tdiscovery.ablations.fig_variant_grid").use("Agg")
    plt = helpers.optional_import("matplotlib.pyplot", "tdiscovery.ablations.fig_variant_grid")

    sub = df[df[x].notna() & df[y].notna()]
    row_vals = sorted(sub[panel_rows].dropna().unique(), key=str)
    col_vals = sorted(sub[panel_cols].dropna().unique(), key=str)
    fig, axes = plt.subplots(
        nrows=max(len(row_vals), 1), ncols=max(len(col_vals), 1),
        figsize=(2.6 * max(len(col_vals), 1), 2.2 * max(len(row_vals), 1)),
        dpi=150, sharex=True, sharey=True, layout="constrained", squeeze=False,
    )
    # Fixed variant -> (marker, color) across ALL panels: per-panel enumerate
    # would recolor a variant wherever another is absent, and the legend
    # would mislabel. pareto_only=True keeps each variant's OWN front (the
    # global is_pareto pools variants and would erase a dominated variant
    # entirely); False plots every run.
    markers = ["o", "^", "s", "d", "v"]
    variants = sorted(sub[variant_col].dropna().unique(), key=str)
    style = {
        v: {"marker": markers[m % len(markers)], "color": f"C{m % 10}"}
        for m, v in enumerate(variants)
    }
    pareto_ids: dict[tuple, list] = {}
    handles: dict[str, object] = {}
    for i, rv in enumerate(row_vals):
        for j, cv in enumerate(col_vals):
            ax = axes[i][j]
            panel = sub[(sub[panel_rows] == rv) & (sub[panel_cols] == cv)]
            for variant, grp in panel.groupby(variant_col):
                if not len(grp):
                    continue
                grp = grp.sort_values(x)
                xs = grp[x].to_numpy(dtype=float)
                ys = grp[y].to_numpy(dtype=float)
                mask = (
                    td_runs.pareto_front(xs, ys)
                    if pareto_only
                    else np.ones(len(xs), dtype=bool)
                )
                (line,) = ax.plot(
                    xs[mask], ys[mask], alpha=0.6, label=str(variant),
                    **style[variant],
                )
                handles.setdefault(str(variant), line)
                pareto_ids.setdefault((rv, cv), []).extend(
                    grp["run_id"].to_numpy()[mask].tolist()
                )
            ax.set_xscale("log")
            ax.set_title(f"{rv} / L{cv}", fontsize=7)
            ax.tick_params(labelsize=6)
            if i == len(row_vals) - 1:
                ax.set_xlabel("L$_0$ ($\\downarrow$)", fontsize=7)
            if j == 0:
                ax.set_ylabel("NMSE ($\\downarrow$)", fontsize=7)
    if handles:
        fig.legend(handles.values(), handles.keys(), fontsize=6,
                   loc="outside upper right")
    return fig, pareto_ids


def variant_effect(df, *, metric: str = Y_COL, variant_col: str = VARIANT_COL,
                   baseline: str, match_cols=("data_key",
                                              "config/val_data/layer")):
    """Mean paired difference of `metric` between each variant and `baseline`
    across matched (data, layer) groups — the number behind "AuxK improves
    NMSE by X on average". Pairs groups by their best (min) metric."""
    rows = []
    best = {}
    for keys, grp in _grouped(df[df[metric].notna()],
                              (*match_cols, variant_col)):
        *match, variant = keys if isinstance(keys, tuple) else (keys,)
        best[(tuple(match), variant)] = float(grp[metric].astype(float).min())
    variants = sorted({v for (_, v) in best} - {baseline}, key=str)
    for variant in variants:
        diffs = [
            best[(m, variant)] - base
            for (m, v), base in best.items()
            if v == baseline and (m, variant) in best
        ]
        if diffs:
            rows.append({
                "variant": variant,
                "baseline": baseline,
                "metric": metric,
                "mean_diff": float(np.mean(diffs)),
                "n_pairs": len(diffs),
            })
    return rows
