"""Cambridge mimic-pair feature discrimination.

The port's copy of `contrib/trait_discovery/notebooks/007_cambridge_mimicry.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/
007_cambridge_mimicry.py (805-line marimo app) as a percent-format script.
The protocol lives in `tdiscovery.mimicry`; this file is the narrative:
count per-pair class balance, harvest every sparse-linear head checkpoint,
and print the cross-pair difficulty, sparsity-tradeoff, and feature-ranking
tables. This is feature discovery, not generalization — the sweep uses the
same shards for train and test, exactly like the reference (its :96 note).

Env vars:
    MIMICRY_RUNS=<runs root with */inference/*/cls_*.pkl checkpoints>
    MIMICRY_SHARDS=<butterfly shards with subspecies_view labels> (optional)
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import mimicry  # noqa: E402

RUNS = pathlib.Path(os.environ.get("MIMICRY_RUNS", "./runs"))
SHARDS = os.environ.get("MIMICRY_SHARDS", "")

# The Heliconius erato / melpomene co-mimic subspecies pairs under study
# (reference MIMIC_PAIRS).
MIMIC_PAIRS = [
    ("notabilis", "plesseni"),
    ("cyrbia", "cythera"),
    ("lativitta", "malleti"),
    ("etylus", "ecuadorensis"),
]
VIEWS = ("dorsal", "ventral")
TASKS = frozenset(
    mimicry.task_name(e, m, v) for e, m in MIMIC_PAIRS for v in VIEWS
)

# %% [markdown]
# ## Class balance per pair task (skip if no shards given)

# %%
if SHARDS:
    for row in mimicry.pair_counts(pathlib.Path(SHARDS), MIMIC_PAIRS, VIEWS):
        flag = "  [INSUFFICIENT]" if row["insufficient_data"] else ""
        print(
            f"{mimicry.pretty_task_name(row['task']):<40} "
            f"erato={row['n_erato']:<4} melpomene={row['n_melpomene']:<4} "
            f"majority={row['majority_acc'] or 0:.2f}{flag}"
        )

# %% [markdown]
# ## Harvest classifier checkpoints

# %%
rows = mimicry.harvest_results(RUNS, filt=mimicry.HarvestFilter(tasks=TASKS))
print(f"Loaded {len(rows)} classifier checkpoints.")

# %% [markdown]
# ## Cross-pair difficulty (hardest first)
# Balanced accuracy vs the majority class — a pair whose margin is ~0 is a
# perfect mimic as far as these SAE features can tell.

# %%
for row in mimicry.difficulty_table(rows):
    print(
        f"{row['pretty']:<40} best={row['best_balanced_acc']:.3f} "
        f"majority={row['majority_acc']:.3f} margin={row['margin']:+.3f} "
        f"(C={row['best_C']}, {row['best_n_nonzero']} features)"
    )

# %% [markdown]
# ## Sparsity vs accuracy

# %%
for row in mimicry.sparsity_tradeoff(rows):
    print(
        f"C={row['C']:<6} mean features={row['mean_n_nonzero']:>7.1f} "
        f"mean balanced acc={row['mean_balanced_acc']:.3f} (n={row['n']})"
    )

# %% [markdown]
# ## Which latents carry the discrimination?
# Positive weight => melpomene, negative => erato.

# %%
for row in sorted(rows, key=lambda r: -r["balanced_acc"])[:4]:
    print(f"\n{mimicry.pretty_task_name(row['task'])} "
          f"(balanced acc {row['balanced_acc']:.3f}):")
    for feat in mimicry.rank_features(row, top_k=5):
        print(
            f"  latent {feat['latent']:>5}  w={feat['weight']:+.3f} "
            f"-> {feat['points_at']}"
        )
