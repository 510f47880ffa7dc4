"""Baseline dictionaries (k-means / PCA / semi-NMF) vs SAEs on probe quality.

The port's copy of `contrib/trait_discovery/notebooks/baselines.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/baselines.py
(776-line marimo app) as a percent-format script: assemble the baseline
probe-results frame (method identity + fit metrics + the same downstream
probe columns as the SAE frame), then line both frames up in one comparison
table — the "do SAEs actually beat cheap dictionaries?" artifact.

Env vars:
    TD_RUNS=<runs root>  TD_SHARDS=<shards root>
    TD_TRACKER=<offline tracker root, optional — for the SAE frame>
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import analysis, figplots  # noqa: E402

RUNS = pathlib.Path(os.environ.get("TD_RUNS", "./runs"))
SHARDS = pathlib.Path(os.environ.get("TD_SHARDS", "./shards"))
TRACKER = os.environ.get("TD_TRACKER", "")

# %% [markdown]
# ## Assemble both frames

# %%
baseline_df = analysis.load_baseline_probe_results_df(RUNS, SHARDS)
sae_df = analysis.load_probe_results_df(
    RUNS, SHARDS,
    tracker_root=pathlib.Path(TRACKER) if TRACKER else None,
)
print(f"{len(baseline_df)} baseline runs, {len(sae_df)} SAE runs.")

# %% [markdown]
# ## Best run per method (probe R, AP, coverage side by side)

# %%
specs = [(m, {"method": m}) for m in ("k-means", "pca", "semi-nmf")]
table = figplots.comparison_table(baseline_df, specs)
print(table.to_string(index=False))

# %% [markdown]
# ## SAEs vs the best baseline
# Same columns, one row per backbone for SAEs plus one per baseline method.

# %%
if len(sae_df):
    sae_table = figplots.table_sae_vs_baselines(sae_df)
    print(sae_table.to_string(index=False))

# %% [markdown]
# ## Fit-side tradeoff
# k-means reports inertia at L0=1; PCA / semi-NMF report reconstruction MSE
# at L0=k. SAE rows live on the same (L0, NMSE) axes in the 001/003 plots.

# %%
for _, row in baseline_df.iterrows():
    print(
        f"{row['method']:>9} {row['run_id']}: fit mse/inertia="
        f"{row['fit_val_mse']} @ L0={row['fit_val_l0']:.0f} | "
        f"val probe R={row['val_probe_r']:.3f}"
    )
