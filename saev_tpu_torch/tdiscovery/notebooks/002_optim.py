"""Optimizer ablation: Adam vs Muon across the sweep.

The port's copy of `contrib/trait_discovery/notebooks/002_optim.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/002_optim.py
(941-line marimo app) as a percent-format script, via the generic variant-
ablation engine (`tdiscovery.ablations` with the optimizer as the variant
column): sweep completeness, per-panel pareto overlays, the paired NMSE
effect of Muon vs Adam, and each optimizer's best downstream-probe run.
(`notebooks/002_ablations.py` gives the run-history view of the same sweep.)

Env vars:
    OPTIM_RUNS=<runs root>  OPTIM_TRACKER=<offline tracker root, optional>
    OPTIM_EXPECTED=<grid size per (optim, data, layer) cell, default 30>
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import ablations, audit_analysis  # noqa: E402

RUNS = pathlib.Path(os.environ.get("OPTIM_RUNS", "./runs"))
TRACKER = os.environ.get("OPTIM_TRACKER", "")
EXPECTED = int(os.environ.get("OPTIM_EXPECTED", "30"))

VARIANT = "config/optim"
GROUPS = (VARIANT, "data_key", "config/val_data/layer")

# %% [markdown]
# ## Frame + completeness

# %%
run_dirs = sorted(p for p in RUNS.iterdir() if p.is_dir()) if RUNS.is_dir() else []
sae_df, _ = audit_analysis.load_audit_frames(
    run_dirs, tracker_root=pathlib.Path(TRACKER) if TRACKER else None
)
print(f"{len(sae_df)} runs.")
for row in ablations.completeness(sae_df, group_cols=GROUPS, expected=EXPECTED):
    status = "done" if row["done"] else f"{row['count']}/{row['expected']}"
    print(f"{row[VARIANT]:>6} | {row['data_key']} "
          f"L{row['config/val_data/layer']}: {status}")

# %% [markdown]
# ## Pareto overlays + the paired NMSE effect of Muon

# %%
fig, _ = ablations.fig_variant_grid(sae_df, variant_col=VARIANT)
fig.savefig("optim_pareto_grid.png")
print("saved optim_pareto_grid.png")
for row in ablations.variant_effect(sae_df, variant_col=VARIANT, baseline="adam"):
    better = "better" if row["mean_diff"] < 0 else "worse"
    print(f"{row['variant']} vs adam: {abs(row['mean_diff']):.4f} NMSE "
          f"{better} (mean over {row['n_pairs']} matched cells)")

# %% [markdown]
# ## Best downstream probe per optimizer

# %%
if "train_probe_r" in sae_df.columns:
    for row in ablations.best_by(sae_df, "train_probe_r", group_cols=GROUPS):
        print(f"{row[VARIANT]:>6} | {row['data_key']} "
              f"L{row['config/val_data/layer']}: "
              f"probe_r={row['train_probe_r']:.3f} ({row['run_id']})")
