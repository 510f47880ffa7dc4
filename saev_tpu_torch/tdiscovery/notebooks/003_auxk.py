"""AuxK ablation study: does dead-latent resurrection earn its cost?

The port's copy of `contrib/trait_discovery/notebooks/003_auxk.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/003_auxk.py
(1,119-line marimo app) as a percent-format script. The analysis protocol
lives in `tdiscovery.ablations`; this file is the narrative: assemble the
flattened run frame, check sweep completeness, compare AuxK-vs-NoAux pareto
fronts per (data, layer) panel, quantify the dead-unit gap and the paired
NMSE effect, and surface the best downstream-probe run per cell.

Env vars:
    AUXK_RUNS=<runs root>   AUXK_TRACKER=<offline tracker root, optional>
    AUXK_EXPECTED=<sweep design size per cell, default 15>
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import ablations, audit_analysis  # noqa: E402

RUNS = pathlib.Path(os.environ.get("AUXK_RUNS", "./runs"))
TRACKER = os.environ.get("AUXK_TRACKER", "")
EXPECTED = int(os.environ.get("AUXK_EXPECTED", "15"))

# %% [markdown]
# ## Assemble the flattened run frame (config/... + summary/... + pareto)

# %%
run_dirs = sorted(p for p in RUNS.iterdir() if p.is_dir()) if RUNS.is_dir() else []
sae_df, _ = audit_analysis.load_audit_frames(
    run_dirs, tracker_root=pathlib.Path(TRACKER) if TRACKER else None
)
print(f"{len(sae_df)} runs.")

# %% [markdown]
# ## Sweep completeness per (variant x data x layer)

# %%
for row in ablations.completeness(sae_df, expected=EXPECTED):
    status = "done" if row["done"] else f"{row['count']}/{row['expected']}"
    print(f"{row['config/sae/activation/aux/key']:>8} | "
          f"{row['data_key']} L{row['config/val_data/layer']}: {status}")

# %% [markdown]
# ## Dead units: the metric AuxK exists to control

# %%
for row in ablations.dead_units(sae_df):
    print(f"{row['config/sae/activation/aux/key']:>8} | "
          f"{row['data_key']} L{row['config/val_data/layer']}: "
          f"train {row['loss_mean']:.1f}%±{row['loss_std']:.1f} "
          f"eval {row['eval_mean']:.1f}%±{row['eval_std']:.1f} "
          f"(n={row['n_trials']})")

# %% [markdown]
# ## Pareto fronts per panel + the paired NMSE effect

# %%
fig, pareto_ids = ablations.fig_variant_grid(sae_df)
fig.savefig("auxk_pareto_grid.png")
print("saved auxk_pareto_grid.png")
for row in ablations.variant_effect(sae_df, baseline="no-aux"):
    better = "better" if row["mean_diff"] < 0 else "worse"
    print(f"{row['variant']} vs {row['baseline']}: "
          f"{abs(row['mean_diff']):.4f} NMSE {better} "
          f"(mean over {row['n_pairs']} matched cells)")

# %% [markdown]
# ## Source vs downstream at the deepest layer

# %%
layers = sorted(sae_df["config/val_data/layer"].dropna().astype(int).unique())
if layers:
    for row in ablations.source_vs_downstream(sae_df, layer=layers[-1]):
        print(row)

# %% [markdown]
# ## Best downstream probe per cell

# %%
if "train_probe_r" in sae_df.columns:
    for row in ablations.best_by(sae_df, "train_probe_r"):
        print(f"{row['config/sae/activation/aux/key']:>8} | "
              f"{row['data_key']} L{row['config/val_data/layer']}: "
              f"probe_r={row['train_probe_r']:.3f} ({row['run_id']})")
