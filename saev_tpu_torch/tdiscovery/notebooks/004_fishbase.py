"""FishBase ecology-trait x body-part latent discovery.

The port's copy of `contrib/trait_discovery/notebooks/004_fishbase.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/
004_fishbase.py (1,398-line marimo app) as a percent-format script. The
analysis protocol lives in `tdiscovery.fishbase`; this file is the narrative:
join FishVista species to FishBase traits, sanity-check trait coverage, score
every latent against (body part x habitat) and (body part x lifestyle-group)
targets, and print the best-latent tables.

Env vars:
    FISHBASE_SHARDS=<fishvista shards with labels.bin>
    FISHBASE_RUN=<trained run dir with token_acts.npz inference artifacts>
    FISHBASE_TRAITS=<csv: genus,species,habitat[,migration,...]>
"""

# %%
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

SHARDS = pathlib.Path(os.environ.get("FISHBASE_SHARDS", "./shards/8692dfa9"))
RUN = pathlib.Path(os.environ.get("FISHBASE_RUN", "./runs/hfpct5ae"))
TRAITS_CSV = pathlib.Path(os.environ.get("FISHBASE_TRAITS", "./fishbase_traits.csv"))

# %% [markdown]
# ## Load activations, part labels, and the species -> trait join

# %%
import scipy.sparse  # noqa: E402

from saev_tpu_torch import disk  # noqa: E402
from saev_tpu_torch.data import Metadata  # noqa: E402
from saev_tpu_torch.tdiscovery import classification as cls_mod  # noqa: E402
from saev_tpu_torch.tdiscovery import fishbase  # noqa: E402

md = Metadata.load(SHARDS)
run = disk.Run(RUN)
token_acts = scipy.sparse.load_npz(
    run.inference / SHARDS.name / "token_acts.npz"
).toarray()
part_labels = np.asarray(
    np.memmap(
        SHARDS / "labels.bin", mode="r", dtype=np.uint8,
        shape=(md.n_examples * md.content_tokens_per_example,),
    )
)

_, labels_by_col = cls_mod.load_image_labels(SHARDS)
species = labels_by_col[next(iter(labels_by_col))]
traits = fishbase.load_trait_table(TRAITS_CSV)
habitat_idx = fishbase.example_traits(species, traits, "habitat")

# %% [markdown]
# ## Trait coverage
# How many examples carry each habitat annotation (reference :938-969)?

# %%
for row in fishbase.trait_coverage(habitat_idx):
    if row["n_examples"]:
        print(f"{row['value']:>18}: {row['n_examples']}")

# %% [markdown]
# ## Best latent per (body part x habitat)

# %%
by_habitat = fishbase.score_part_by_trait(
    token_acts, part_labels, habitat_idx, md.content_tokens_per_example
)
for row in by_habitat.table():
    if row["score"] > 0.1:
        print(
            f"{row['part']:>14} x {row['target']:<18} -> latent "
            f"{row['latent']:>5}  |r|={row['score']:.3f}"
        )

# %% [markdown]
# ## Best latent per (body part x lifestyle group)
# Cruisers vs maneuverers, pelagic vs demersal, shallow vs deep
# (reference :775-846).

# %%
by_group = fishbase.score_part_by_comparison(
    token_acts, part_labels, habitat_idx, md.content_tokens_per_example
)
for row in by_group.table():
    if row["score"] > 0.1:
        print(
            f"{row['part']:>14} x {row['target']:<12} -> latent "
            f"{row['latent']:>5}  |r|={row['score']:.3f}"
        )

# %% [markdown]
# ## Latents worth rendering visuals for

# %%
latents = sorted(by_habitat.best_latents() | by_group.best_latents())
print(" ".join(str(i) for i in latents))
