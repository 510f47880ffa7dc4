"""Probe-results analysis notebook: runs root → DataFrame → figure battery.

The port's copy of `contrib/trait_discovery/notebooks/metrics.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's 2,160-line marimo notebook
(`contrib/trait_discovery/notebooks/metrics.py`) as a percent-format script.
The research logic lives in library code (`tdiscovery.analysis` for the
schema-validated DataFrame, `tdiscovery.figplots` for the figure/table
engines) so it is unit-tested (tests/test_td_analysis.py); this file is the
narrative: assemble, inspect, and save the battery.

Env: TD_RUNS_ROOT=<.../saev/runs> TD_SHARDS_ROOT=<.../saev/shards>
     [TD_TRACKER=<.wandb dir>] [TD_OUT=./figures] [TD_MODEL=<model key>]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import analysis, figplots  # noqa: E402

RUNS_ROOT = pathlib.Path(os.environ.get("TD_RUNS_ROOT", "./saev/runs"))
SHARDS_ROOT = pathlib.Path(os.environ.get("TD_SHARDS_ROOT", "./saev/shards"))
TRACKER = os.environ.get("TD_TRACKER")
OUT = pathlib.Path(os.environ.get("TD_OUT", "./figures"))

# %% [markdown]
# ## The probe-results DataFrame
# One row per run with train+val probe metrics; schema-validated (wrong
# dtype or out-of-range value raises with the column named).

# %%
if __name__ == "__main__":
    df = analysis.load_probe_results_df(
        RUNS_ROOT, SHARDS_ROOT,
        tracker_root=pathlib.Path(TRACKER) if TRACKER else None,
    )
    print(df.head().to_string())
    print(f"{len(df)} runs; models: {sorted(df['model'].unique()) if len(df) else []}")

    if len(df) == 0:
        raise SystemExit("No runs with train+val probe metrics found.")

    # %% [markdown]
    # ## Overfitting diagnostic: train vs val CE and probe R

    # %%
    figures = {}
    fig, _ = figplots.fig_overfitting(df)
    figures["overfitting"] = fig

    # %% [markdown]
    # ## Layerwise batteries per backbone: explained variance, L0, mAP,
    # probe R, purity, coverage — one panel per layer

    # %%
    model = os.environ.get("TD_MODEL") or df["model"].mode().iloc[0]
    layers = sorted(df[df["model"] == model]["layer"].unique())
    n_layers = int(max(layers)) + 1 if layers else 1
    kw = dict(model=model, layers=[int(l) for l in layers], n_layers=n_layers)
    for name, maker in (
        ("layerwise_ev", figplots.fig_layerwise_explained_variance),
        ("layerwise_l0", figplots.fig_layerwise_log_l0),
        ("layerwise_map", figplots.fig_layerwise_map),
        ("layerwise_probe_r", figplots.fig_layerwise_probe_r),
        ("layerwise_purity", figplots.fig_layerwise_purity),
        ("layerwise_cov", figplots.fig_layerwise_cov),
    ):
        try:
            fig, _ = maker(df, **kw)
            figures[name] = fig
        except (KeyError, TypeError) as err:
            print(f"Skipping {name}: {err}")

    # %% [markdown]
    # ## Tradeoff + method tables

    # %%
    tables = {}
    if df["sae_val_l0"].notna().any():
        fig, _ = figplots.fig_tradeoff(df)
        figures["tradeoff"] = fig
    tables["sae_vs_baselines"] = figplots.table_sae_vs_baselines(df)
    tables["sae_variants"] = figplots.table_sae_variants(df)
    tables["vit_family"] = figplots.table_vit_family(df)

    written = figplots.save_battery(figures, tables, OUT)
    print(f"Saved {len(written)} artifacts to {OUT}:")
    for fpath in written:
        print(" ", fpath)
