"""Birdsong clip-gallery browser assembly: runs roots → audio galleries.

The port's copy of `contrib/birdsong/notebooks/clips.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of the reference's marimo notebook
(`contrib/birdsong/notebooks/clips.py`, 349 lines: checkpoint dropdown over
runs with clip galleries, shards dropdown, per-latent clip navigation with
spectrograms and audio players). Discovery lives in `birdsong.browse`
(tested in tests/test_birdsong_browse.py); the gallery page is
`scripts/make_html.py` — this driver wires them into a static site.

Env: BS_RUNS_ROOTS=<root1>[,root2...] [BS_OUT=./clip_galleries]
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.birdsong import browse  # noqa: E402

ROOTS = [
    pathlib.Path(p)
    for p in os.environ.get("BS_RUNS_ROOTS", "./saev/runs").split(",")
]
OUT = pathlib.Path(os.environ.get("BS_OUT", "./clip_galleries"))

# %% [markdown]
# ## Discover runs with clip galleries
# A run is browsable when `birdsong.visuals.worker_fn` wrote
# `inference/<shards>/clips/<latent>/` (spectrograms + filtered audio).

# %%
if __name__ == "__main__":
    clip_runs = browse.discover_runs(ROOTS)
    print(f"{len(clip_runs)} runs with clip galleries under {ROOTS}")
    for clip_run in clip_runs:
        print(f"  {clip_run.run_dir.name}: {', '.join(clip_run.shards)}")
    if not clip_runs:
        raise SystemExit("No browsable runs found.")

    # %%
    written = browse.build_browsers(ROOTS, OUT, runs=clip_runs)
    print(f"Wrote {len(written)} pages; open {OUT / 'index.html'}")
