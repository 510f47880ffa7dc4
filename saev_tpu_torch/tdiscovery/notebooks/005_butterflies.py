"""Butterflies SAE study: run frames → per-layer pareto → classifier tradeoffs.

The port's copy of `contrib/trait_discovery/notebooks/005_butterflies.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/005_bufferflies.py`, 837 lines): assemble
the SAE-run and classifier frames over the butterfly runs, draw the per-layer
L0/NMSE pareto frontiers (:388-459), and the classifier sparsity/accuracy
tradeoff (:477-557). The engines live in `tdiscovery.audit_analysis`
(tested in tests/test_td_ablations.py / test_td_study_figs.py).

Env: TD_RUNS_ROOT=<.../saev/runs> [TD_TRACKER=<.wandb dir>] [TD_OUT=./figures/005]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import audit_analysis, figplots  # noqa: E402

RUNS_ROOT = pathlib.Path(os.environ.get("TD_RUNS_ROOT", "./saev/runs"))
TRACKER = os.environ.get("TD_TRACKER")
OUT = pathlib.Path(os.environ.get("TD_OUT", "./figures/005"))

# %% [markdown]
# ## Frames: one row per run (pareto-marked) / per audited classifier

# %%
if __name__ == "__main__":
    run_dirs = sorted(p for p in RUNS_ROOT.iterdir() if p.is_dir())
    sae_df, clf_df = audit_analysis.load_audit_frames(
        run_dirs, tracker_root=pathlib.Path(TRACKER) if TRACKER else None
    )
    print(f"{len(sae_df)} runs, {len(clf_df)} classifier rows")
    if not len(sae_df):
        raise SystemExit("No runs found.")

    # %% [markdown]
    # ## Per-layer pareto frontiers (TopK + AuxK runs)

    # %%
    figures, tables = {}, {}
    fig, pareto_ckpts = audit_analysis.fig_pareto_frontiers(
        sae_df,
        filters={
            "config/sae/activation/key": "top-k",
            "config/sae/activation/aux/key": "auxk",
        },
    )
    figures["pareto_frontiers"] = fig
    for layer, ids in pareto_ckpts.items():
        print(f"layer {layer}: pareto ckpts {ids}")

    # %% [markdown]
    # ## Classifier sparsity vs accuracy

    # %%
    if len(clf_df):
        fig, best = audit_analysis.fig_sparsity_accuracy(clf_df)
        figures["sparsity_accuracy"] = fig
        tables["best_by_type"] = best
        print(best.to_string(index=False))

    written = figplots.save_battery(figures, tables, OUT)
    print(f"Saved {len(written)} artifacts to {OUT}")
