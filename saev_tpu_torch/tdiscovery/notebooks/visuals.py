"""Latent-gallery browser assembly: runs roots → discovered galleries → HTML.

The port's copy of `contrib/trait_discovery/notebooks/visuals.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/trait_discovery/notebooks/visuals.py`: checkpoint dropdown over
runs with inference images, shards dropdown, per-latent next/prev gallery).
Discovery lives in `tdiscovery.browse` (tested in tests/test_td_browse.py);
the gallery app is `saev_tpu_torch.interactive.features` — this driver wires the
two together into a static site.

Env: TD_RUNS_ROOTS=<root1>[,root2...] [TD_OUT=./galleries] [TD_N_FEATURES=200]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery import browse  # noqa: E402

ROOTS = [
    pathlib.Path(p)
    for p in os.environ.get("TD_RUNS_ROOTS", "./saev/runs").split(",")
]
OUT = pathlib.Path(os.environ.get("TD_OUT", "./galleries"))
N_FEATURES = int(os.environ.get("TD_N_FEATURES", "200"))

# %% [markdown]
# ## Discover runs with image galleries
# A run is browsable when `tdiscovery.visuals.worker_fn` wrote
# `inference/<shards>/images/<latent>/` for it.

# %%
if __name__ == "__main__":
    galleries = browse.discover_runs(ROOTS)
    print(f"{len(galleries)} runs with galleries under {ROOTS}")
    for gallery in galleries:
        print(f"  {gallery.run_dir.name}: {', '.join(gallery.shards)}")
    if not galleries:
        raise SystemExit("No browsable runs found.")

    # %% [markdown]
    # ## Assemble the static browser site

    # %%
    written = browse.build_browsers(
        ROOTS, OUT, n_features=N_FEATURES, runs=galleries
    )
    print(f"Wrote {len(written)} pages; open {OUT / 'index.html'}")
