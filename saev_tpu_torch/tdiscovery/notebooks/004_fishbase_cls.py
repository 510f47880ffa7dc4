"""FishBase classification study: eval artifacts → frames → rules → tables.

The port's copy of `contrib/trait_discovery/notebooks/004_fishbase_cls.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/004_fishbase_cls.py`, 662 lines):
aggregate sparse-classifier evals across runs, inspect decision-tree heads as
latent-threshold rules, tabulate the top latents per ecology class, and list
latents shared across classes. The logic lives in `tdiscovery.clsview`
(tested in tests/test_td_clsview.py).

Env: TD_RUNS_ROOT=<.../saev/runs> [TD_TRACKER=<.wandb dir>] [TD_TASK=<task name>]
"""

# %%
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import classification, clsview  # noqa: E402

RUNS_ROOT = pathlib.Path(os.environ.get("TD_RUNS_ROOT", "./saev/runs"))
TRACKER = os.environ.get("TD_TRACKER")

# %% [markdown]
# ## Classification-results frame
# One row per (run, shards, task); per-class view explodes APs + top latents.

# %%
if __name__ == "__main__":
    run_dirs = sorted(p for p in RUNS_ROOT.iterdir() if p.is_dir())
    df = clsview.load_cls_results_df(
        run_dirs, tracker_root=pathlib.Path(TRACKER) if TRACKER else None
    )
    print(df.to_string(index=False) if len(df) else "No classification evals.")
    if not len(df):
        raise SystemExit(1)

    task = os.environ.get("TD_TASK") or df["task"].iloc[0]
    per_class = clsview.load_cls_results_df(run_dirs, per_class=True)
    per_class = per_class[per_class["task"] == task]
    print(f"\nPer-class view for '{task}' ({len(per_class)} rows):")
    print(
        per_class[["run_id", "class_name", "ap", "top_latents"]]
        .sort_values("ap", ascending=False)
        .head(20)
        .to_string(index=False)
    )

    # %% [markdown]
    # ## Best run on the task: per-class AP + top latents + shared latents

    # %%
    best = df[df["task"] == task].sort_values("mean_ap", ascending=False).iloc[0]
    print(f"\nBest run for '{task}': {best['run_id']} (mAP {best['mean_ap']:.3f})")
    art = RUNS_ROOT / str(best["run_id"]) / "inference" / str(best["shard"])
    results = json.loads((art / f"classification_{task}.json").read_text())
    print(clsview.top_latents_table(results).to_string(index=False))
    shared = clsview.shared_latents(results)
    if shared:
        print("\nLatents in the top-10 of multiple classes:")
        for latent, names in shared.items():
            print(f"  latent {latent}: {', '.join(names)}")

    # %% [markdown]
    # ## Decision-tree heads as latent-threshold rules

    # %%
    for fpath in sorted(art.glob("cls_*depth*.pkl")):
        header, payload = classification.load_classifier_checkpoint(fpath)
        print(f"\n{fpath.name} (test acc {header['test_acc']:.3f}):")
        print(clsview.tree_rules(payload["classifier"], header["class_names"],
                                 max_depth=3))
