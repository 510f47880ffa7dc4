"""Cambridge-butterfly SAE training study: pareto + latent-frequency views.

The port's copy of `contrib/trait_discovery/notebooks/007_cambridge_sae.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/007_cambridge_sae.py`, 842 lines): the
SAE-run frame with pareto marking, the per-layer frontier plot (:406-543),
and the pareto checkpoints' latent frequency / mean-value statistics
(load_freqs/load_mean_values :552-588). Engines: `tdiscovery.audit_analysis`
+ `tdiscovery.analysis`.

Env: TD_RUNS_ROOT=<.../saev/runs> [TD_TRACKER=<.wandb dir>] [TD_OUT=./figures/007sae]
"""

# %%
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import analysis, audit_analysis, figplots  # noqa: E402

RUNS_ROOT = pathlib.Path(os.environ.get("TD_RUNS_ROOT", "./saev/runs"))
TRACKER = os.environ.get("TD_TRACKER")
OUT = pathlib.Path(os.environ.get("TD_OUT", "./figures/007sae"))

# %% [markdown]
# ## SAE-run frame + per-layer pareto frontiers

# %%
if __name__ == "__main__":
    import saev_tpu_torch.disk

    run_dirs = sorted(p for p in RUNS_ROOT.iterdir() if p.is_dir())
    sae_df, _ = audit_analysis.load_audit_frames(
        run_dirs, tracker_root=pathlib.Path(TRACKER) if TRACKER else None
    )
    print(f"{len(sae_df)} runs")
    if not len(sae_df):
        raise SystemExit("No runs found.")
    fig, pareto_ckpts = audit_analysis.fig_pareto_frontiers(sae_df)
    figures = {"pareto_frontiers": fig}

    # %% [markdown]
    # ## Latent statistics of the pareto checkpoints
    # Dead fraction and log-frequency spread per checkpoint, from the
    # inference sparsity.pt / mean_values.pt artifacts.

    # %%
    rows = []
    for layer, ids in pareto_ckpts.items():
        for run_id in ids:
            run = saev_tpu_torch.disk.Run(RUNS_ROOT / run_id)
            for shard_dir in sorted(p for p in run.inference.iterdir() if p.is_dir()):
                if not (shard_dir / "sparsity.pt").exists():
                    continue
                freqs = analysis.load_freqs(run, shard_dir.name)
                values = analysis.load_mean_values(run, shard_dir.name)
                with np.errstate(divide="ignore"):
                    lf = np.log10(freqs[freqs > 0])
                rows.append({
                    "layer": layer,
                    "run_id": run_id,
                    "shard": shard_dir.name,
                    "d_sae": int(freqs.size),
                    "dead_frac": float((freqs == 0).mean()),
                    "log10_freq_median": float(np.median(lf)) if lf.size else float("nan"),
                    "mean_value_mean": float(values[freqs > 0].mean()) if (freqs > 0).any() else float("nan"),
                })
    if rows:
        import pandas as pd

        stats = pd.DataFrame(rows)
        print(stats.to_string(index=False))
        tables = {"pareto_latent_stats": stats}
    else:
        tables = {}

    written = figplots.save_battery(figures, tables, OUT)
    print(f"Saved {len(written)} artifacts to {OUT}")
