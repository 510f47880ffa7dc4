"""PE (Perception Encoder) probe study: probe frame + purity at several k.

The port's copy of `contrib/trait_discovery/notebooks/008_pe.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/008_pe.py`, 702 lines): the probe-results
frame (probe R vs the prevalence-baseline CE, reconstruction NMSE on both
datasets, AP/coverage), plus mean purity of the best latents' top-k patches
at k in {16, 64, 256} (:461-471) and the tradeoff plot. Engines:
`tdiscovery.analysis` (load_probe_results_df, purity_at) + figplots.

Env: TD_RUNS_ROOT=<.../saev/runs> TD_SHARDS_ROOT=<.../saev/shards>
     [TD_TRACKER=<.wandb dir>] [TD_OUT=./figures/008]
"""

# %%
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import analysis, figplots  # noqa: E402

RUNS_ROOT = pathlib.Path(os.environ.get("TD_RUNS_ROOT", "./saev/runs"))
SHARDS_ROOT = pathlib.Path(os.environ.get("TD_SHARDS_ROOT", "./saev/shards"))
TRACKER = os.environ.get("TD_TRACKER")
OUT = pathlib.Path(os.environ.get("TD_OUT", "./figures/008"))
PURITY_KS = (16, 64, 256)

# %% [markdown]
# ## Probe-results frame (one row per run with train+val probe metrics)

# %%
if __name__ == "__main__":
    import saev_tpu_torch.disk

    df = analysis.load_probe_results_df(
        RUNS_ROOT, SHARDS_ROOT,
        tracker_root=pathlib.Path(TRACKER) if TRACKER else None,
    )
    print(f"{len(df)} runs with probe metrics")
    if not len(df):
        raise SystemExit("No probe results found.")
    print(df[[c for c in (
        "run_id", "model", "layer", "val_probe_r", "val_mean_ap",
        "val_nmse", "cov_at_0_5",
    ) if c in df.columns]].to_string(index=False))

    # %% [markdown]
    # ## Purity at k in {16, 64, 256} for each run's best latents
    # Re-derived from the probe1d metrics artifacts (reference get_mean_purity).

    # %%
    for _, row in df.iterrows():
        run = saev_tpu_torch.disk.Run(RUNS_ROOT / row["run_id"])
        train_shard = row["train_probe_shards"]
        val_shard = row["val_probe_shards"]
        metrics_fpath = (
            run.inference / val_shard / f"probe1d_metrics__train-{train_shard}.npz"
        )
        if not metrics_fpath.exists():
            continue
        with np.load(run.inference / train_shard / "probe1d_metrics.npz") as fd:
            best_i = np.argmin(fd["loss"], axis=0)
        with np.load(metrics_fpath) as fd:
            top_labels = fd.get("top_labels")
        if top_labels is None:
            continue
        purities = {
            k: analysis.purity_at(top_labels, best_i, k=k)
            for k in PURITY_KS if top_labels.shape[1] >= k
        }
        print(f"{row['run_id']}: " + ", ".join(
            f"purity@{k}={v:.3f}" for k, v in purities.items()
        ))

    # %% [markdown]
    # ## Probe-R / NMSE tradeoff

    # %%
    figures = {}
    if df["sae_val_l0"].notna().any():
        fig, _ = figplots.fig_tradeoff(df)
        figures["tradeoff"] = fig
    fig, _ = figplots.fig_overfitting(df)
    figures["overfitting"] = fig
    written = figplots.save_battery(figures, {}, OUT)
    print(f"Saved {len(written)} artifacts to {OUT}")
