"""Heliconius mimicry exploration: classifier checkpoints -> pooled features
-> render plan.

The port's copy of `contrib/mimics/exps/001-heliconius/exploration.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Driver for the reference's exploration notebook (reference contrib/mimics/
exps/001-heliconius/exploration.py, whose `mimics.checkpoints` /
`mimics.features` imports were never shipped — saev_tpu_torch.mimics.checkpoints
implements them):

1. Step 1 — scan run dirs for a mimic task's classifier checkpoints.
2. Step 2 — select by feature count / accuracy, pool top features per head.
3. Step 3 — build a render plan (class x example x latents) and optionally
   render galleries through mimics.render.

Env: MIMICS_RUNS=<runs root> MIMICS_SHARD=<shard hash>
     MIMICS_TASK=<task name> [MIMICS_RUN_IDS=a,b] [MIMICS_LABELS=<json file>]
     [MIMICS_OUT=./exploration]
"""

# %%
import json
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[4]))

from saev_tpu_torch.mimics import checkpoints, tasks  # noqa: E402

RUNS = pathlib.Path(os.environ.get("MIMICS_RUNS", "./runs"))
SHARD = os.environ.get("MIMICS_SHARD", "")
TASK = os.environ.get("MIMICS_TASK", "")
RUN_IDS = tuple(r for r in os.environ.get("MIMICS_RUN_IDS", "").split(",") if r)
LABELS_FPATH = os.environ.get("MIMICS_LABELS")
OUT = pathlib.Path(os.environ.get("MIMICS_OUT", "./exploration"))

if __name__ == "__main__":
    # %% [markdown]
    # ## Step 1 — discover classifier checkpoints

    # %%
    ckpt_rows = checkpoints.discover_checkpoints(
        checkpoints.DiscoverCheckpointsConfig(
            run_root_dpath=RUNS, shard_id=SHARD, task_name=TASK, run_ids=RUN_IDS
        )
    )
    for row in ckpt_rows:
        print(
            f"{row['run_id']} {row['cls_type']:>14} C={row['c_value']} "
            f"n_features={row['n_features']} test_acc={row['test_acc']}"
        )

    # %% [markdown]
    # ## Step 2 — select + pool features

    # %%
    selected = checkpoints.select_checkpoints(ckpt_rows, top_k=5)
    pooled = checkpoints.pool_features(selected, per_ckpt=10)
    print(f"{len(pooled)} pooled features: {list(pooled)[:20]}")

    # %% [markdown]
    # ## Step 3 — render plan

    # %%
    if LABELS_FPATH:
        labels = json.loads(pathlib.Path(LABELS_FPATH).read_text())
        grouping = tasks.make_label_grouping(TASK)
        plan = checkpoints.build_render_plan(
            labels, pooled, groups=grouping.groups, n_per_class=4
        )
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "render_plan.json").write_text(json.dumps(plan, indent=2))
        print(f"wrote {len(plan)}-row render plan to {OUT / 'render_plan.json'}")
