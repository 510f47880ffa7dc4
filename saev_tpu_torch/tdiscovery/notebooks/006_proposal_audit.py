"""Proposal-audit protocol driver.

The port's copy of `contrib/trait_discovery/notebooks/006_proposal_audit.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/
006_proposal_audit.py: run the full "task-driven feature selection + concept
audit" loop for one SAE run — train sparse heads on several task definitions,
audit the union of their feature rankings against segmentation masks, and
tabulate Yield@B / AUC_B per head (tdiscovery.classification implements every
stage; this is the orchestration narrative).

Env: TD_RUN=<run dir> TD_TRAIN_SHARDS=<shards> TD_TEST_SHARDS=<shards>
     [TD_SOURCE_COL=class] [TD_OUT=./figures]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import classification as cls_mod  # noqa: E402

RUN = pathlib.Path(os.environ.get("TD_RUN", "./runs/abcdefg"))
TRAIN_SHARDS = pathlib.Path(os.environ.get("TD_TRAIN_SHARDS", "./shards/01234567"))
TEST_SHARDS = pathlib.Path(os.environ.get("TD_TEST_SHARDS", "./shards/abcdef01"))
SOURCE_COL = os.environ.get("TD_SOURCE_COL", "class")
OUT = pathlib.Path(os.environ.get("TD_OUT", "./figures"))

# %% [markdown]
# ## Stage 1 — proposal: train heads of both families on the task

# %%
HEADS = [
    cls_mod.SparseLinear(C=0.01),
    cls_mod.SparseLinear(C=0.1),
    cls_mod.DecisionTree(max_depth=8),
]
task = cls_mod.LabelGrouping(name="audit_demo", source_col=SOURCE_COL)

checkpoints = []
if __name__ == "__main__":
    import saev_tpu_torch.disk

    run = saev_tpu_torch.disk.Run(RUN)
    for head in HEADS:
        cfg = cls_mod.TrainConfig(
            run=RUN, train_shards=TRAIN_SHARDS, test_shards=TEST_SHARDS,
            task=task, cls=head,
        )
        cls_mod.train_worker_fn(cfg)
        checkpoints.append(cls_mod.ckpt_fpath(run, cfg))

    # %% [markdown]
    # ## Stage 2 — audit: ground the union of top features in segmentation AP

    # %%
    cls_mod.audit_worker_fn(cls_mod.AuditConfig(
        run=RUN, test_shards=TEST_SHARDS,
        cls_checkpoints=tuple(checkpoints),
        max_budget=1000, budgets=(3, 10, 30, 100, 300, 1000), tau=0.3,
    ))

    # %% [markdown]
    # ## Stage 3 — tabulate Yield@B per head (pdf/csv artifacts via figures)

    # %%
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "td_figures", pathlib.Path(__file__).parent / "figures.py"
    )
    figures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(figures)

    from saev_tpu_torch.tdiscovery.runs import RunSpec

    shard = TEST_SHARDS.name
    audit = figures.table_audit(
        [RunSpec(run=RUN, method="sae", note="006_proposal_audit")],
        shard, name="proposal_audit", out=OUT,
    )
    print(audit.to_string(index=False))

    # %% [markdown]
    # ## Stage 4 — hypothesis battery over every audited run
    # The analysis half of the reference notebook (006:326-3166): assemble
    # (sae_df, clf_df) across runs, then test what drives Yield — layer,
    # classifier family, sparsity, top-k — with fitted slopes/R² saved
    # alongside the figures in audit_stats.json.

    # %%
    from saev_tpu_torch.tdiscovery import audit_analysis

    extra = [pathlib.Path(p) for p in os.environ.get("TD_RUNS", "").split(":") if p]
    stats = audit_analysis.run_battery([RUN, *extra], OUT / "audit_battery")
    print({k: v for k, v in stats.items() if k.startswith("h1")})
