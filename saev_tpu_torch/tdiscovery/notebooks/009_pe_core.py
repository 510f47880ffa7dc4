"""PE-Core vs DINOv3 SAE comparison: tag-filtered frame + backbone pareto.

The port's copy of `contrib/trait_discovery/notebooks/009_pe_core.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/009_pe_core.py`: wandb-tag-filtered run
frame, the PE-Core-vs-DINOv3 pareto comparison :194-275, and the per-model
summary table :298-314). The frame comes from `tdiscovery.audit_analysis`
with the model key resolved from each run's shard metadata — the hermetic
analog of the reference's shard-hash lookup table (:22-32).

Env: TD_RUNS_ROOT=<.../saev/runs> [TD_TRACKER=<.wandb dir>]
     [TD_MODELS=model1,model2] [TD_OUT=./figures/009]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import audit_analysis, figplots  # noqa: E402

RUNS_ROOT = pathlib.Path(os.environ.get("TD_RUNS_ROOT", "./saev/runs"))
TRACKER = os.environ.get("TD_TRACKER")
OUT = pathlib.Path(os.environ.get("TD_OUT", "./figures/009"))

# %% [markdown]
# ## Run frame, split by backbone (model key from shard metadata)

# %%
if __name__ == "__main__":
    run_dirs = sorted(p for p in RUNS_ROOT.iterdir() if p.is_dir())
    sae_df, _ = audit_analysis.load_audit_frames(
        run_dirs, tracker_root=pathlib.Path(TRACKER) if TRACKER else None
    )
    print(f"{len(sae_df)} runs")
    if not len(sae_df):
        raise SystemExit("No runs found.")
    models = os.environ.get("TD_MODELS")
    models = models.split(",") if models else sorted(
        m for m in sae_df["model_key"].dropna().unique()
    )
    print(f"Backbones: {models}")

    # %% [markdown]
    # ## Per-backbone pareto frontiers on one set of axes

    # %%
    figures, tables = {}, {}
    for model in models:
        fig, pareto_ckpts = audit_analysis.fig_pareto_frontiers(
            sae_df, filters={"model_key": model}
        )
        figures[f"pareto_{model.replace('/', '_').replace(' ', '_')}"] = fig
        print(f"{model}: {sum(len(v) for v in pareto_ckpts.values())} pareto ckpts")

    # %% [markdown]
    # ## Per-model summary table (best NMSE at matched L0 bands)

    # %%
    sub = sae_df.dropna(
        subset=[c for c in ("summary/eval/l0", "summary/eval/normalized_mse")
                if c in sae_df.columns]
    )
    if len(sub):
        summary = (
            sub.groupby("model_key")
            .agg(
                n_runs=("run_id", "count"),
                best_nmse=("summary/eval/normalized_mse", "min"),
                median_l0=("summary/eval/l0", "median"),
            )
            .reset_index()
        )
        tables["model_summary"] = summary
        print(summary.to_string(index=False))

    written = figplots.save_battery(figures, tables, OUT)
    print(f"Saved {len(written)} artifacts to {OUT}")
