"""Explore birdsong SAE latents: spectrograms, top clips, latent summaries.

The port's copy of `contrib/birdsong/notebooks/explore.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/birdsong/notebooks/001_explore.py +
clips.py (marimo notebooks; marimo is not a dependency here, so this is a
percent-format script — run it cell-by-cell in any editor, export to .ipynb
with scripts/export_notebook.py, or run top to bottom).

Prereqs: a trained run with inference artifacts over Bird-MAE shards
(launch.py inference) — the same inputs as birdsong.visuals.
"""

# %% [markdown]
# # Birdsong latent exploration
# Point `RUN` and `SHARDS` at a trained SAE run and its Bird-MAE activation
# shards, then walk through the cells.

# %%
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

RUN = pathlib.Path(os.environ.get("BIRDSONG_RUN", "./runs/abcdefg"))
SHARDS = pathlib.Path(os.environ.get("BIRDSONG_SHARDS", "./shards/5e37a03c"))

# %% [markdown]
# ## Load inference artifacts (sparsity, mean values, token activations)

# %%
import scipy.sparse  # noqa: E402

from saev_tpu_torch import disk  # noqa: E402
from saev_tpu_torch.data import Metadata  # noqa: E402

md = Metadata.load(SHARDS)
run = disk.Run(RUN)
inf_dir = RUN / "inference" / md.hash
token_acts = scipy.sparse.load_npz(inf_dir / "token_acts.npz")
print(f"{token_acts.shape[0]} tokens x {token_acts.shape[1]} latents, "
      f"{token_acts.nnz / token_acts.shape[0]:.1f} mean L0")

# %% [markdown]
# ## Rank latents by firing frequency and mean value

# %%
freq = np.asarray((token_acts > 0).mean(axis=0)).ravel()
mean_val = np.asarray(token_acts.mean(axis=0)).ravel()
interesting = np.argsort(-mean_val * (freq > 1e-4) * (freq < 1e-1))[:25]
for lat in interesting[:10]:
    print(f"latent {lat}: freq {freq[lat]:.5f}, mean {mean_val[lat]:.4f}")

# %% [markdown]
# ## Render spectrogram galleries + filtered audio for the top latents
# (delegates to birdsong.visuals — writes PNG spectrograms with SAE overlays
# and time/frequency-masked WAV clips per latent)

# %%
from saev_tpu_torch.birdsong import visuals  # noqa: E402

cfg = visuals.Config(
    run=RUN, shards=SHARDS, latents=tuple(int(i) for i in interesting[:8]),
    n_latents=16,
)
visuals.worker_fn(cfg)
print(f"wrote galleries under {RUN}/inference/{md.hash}/clips/")

# %% [markdown]
# ## Browse
# `python -m saev_tpu_torch.birdsong make_html --run <RUN> --shards <SHARDS>`
# builds the clickable HTML browser over these galleries.

# %% [markdown]
# ## Sweep analysis: L0/NMSE pareto per layer
# The reference's 001_explore sweep cells (:353-530): one panel per recorded
# layer, the pareto frontier of the Bird-MAE SAE sweep, plus the frontier
# run ids — the checkpoints worth rendering clips for. Uses the offline
# tracker written by training (`BIRDSONG_TRACKER`, default `.wandb/saev`).

# %%
import collections  # noqa: E402

from saev_tpu_torch.interactive import metrics as explorer  # noqa: E402

TRACKER = pathlib.Path(os.environ.get("BIRDSONG_TRACKER", ".wandb/saev"))

if TRACKER.is_dir():
    sweep_runs = explorer.load_runs_local(TRACKER)
    by_layer = collections.defaultdict(list)
    for r in sweep_runs:
        layer = ((r.get("config", {}).get("val_data") or {}).get("layer"))
        l0 = explorer.last_value(r.get("history", []), "loss/l0")
        nmse = explorer.last_value(
            r.get("history", []), "metrics/normalized_mse"
        )
        if layer is not None and l0 is not None and nmse is not None:
            by_layer[int(layer)].append((float(l0), float(nmse), r.get("id")))

    pareto_ckpts = {}
    for layer, rows in sorted(by_layer.items()):
        rows.sort()
        frontier, best = [], float("inf")
        for l0, nmse, rid in rows:
            if nmse < best:
                best = nmse
                frontier.append((l0, nmse, rid))
        pareto_ckpts[layer] = [rid for _, _, rid in frontier]
        print(f"layer {layer}: {len(rows)} runs, frontier:")
        for l0, nmse, rid in frontier:
            print(f"  {rid}: L0={l0:8.1f} NMSE={nmse:.4f}")
    print("\nrender clips for:", " ".join(
        rid for ids in pareto_ckpts.values() for rid in ids
    ))
else:
    print(f"(no tracker at {TRACKER}; skipping sweep analysis)")
