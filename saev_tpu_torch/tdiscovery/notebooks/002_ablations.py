"""Optimizer + AuxK ablation study across a trained sweep.

The port's copy of `contrib/trait_discovery/notebooks/002_ablations.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/002_optim.py
and 003_auxk.py (marimo sweep-comparison notebooks) in the repo's
percent-format style: group a sweep's runs by optimizer (Adam vs Muon) and by
AuxK configuration (on/off, k_aux, alpha), compare convergence curves and the
final L0/NMSE trade-off per group, and report dead-latent trajectories (the
quantity AuxK exists to control).

Data source: local JSONL tracker dirs (`.wandb/<project>/<id>/metrics.jsonl`)
or wandb, via the sweep explorer's loaders.
"""

# %%
import collections
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.interactive import metrics as explorer

TRACKER_DIR = pathlib.Path(os.environ.get("SAEV_TRACKER", ".wandb/saev"))
TAG = os.environ.get("SAEV_TAG", "")

# %%
runs = explorer.load_runs_local(TRACKER_DIR, tag=TAG)
print(f"{len(runs)} runs loaded from {TRACKER_DIR}")


# %% [markdown]
# ## Grouping keys


# %%
def optim_key(run: dict) -> str:
    cfg = run.get("config", {})
    return f"{cfg.get('optim', '?')}(lr={cfg.get('lr')})"


def auxk_key(run: dict) -> str:
    act = (run.get("config", {}).get("sae") or {}).get("activation") or {}
    aux = act.get("aux") or {}
    if aux.get("key") != "auxk":
        return "no-aux"
    return f"auxk(k={aux.get('k_aux')}, a={aux.get('alpha')})"


def grouped(key_fn):
    groups = collections.defaultdict(list)
    for run in runs:
        groups[key_fn(run)].append(run)
    return dict(sorted(groups.items()))


# %% [markdown]
# ## Optimizer comparison: final loss + convergence speed
# Convergence speed = steps to reach within 10% of the run's final MSE.


# %%
def steps_to_converge(history, final, slack=1.1):
    for row in history:
        if row.get("loss/mse") is not None and row["loss/mse"] <= final * slack:
            return row.get("_step", row.get("step"))
    return None


for name, members in grouped(optim_key).items():
    finals, speeds = [], []
    for run in members:
        hist = run.get("history", [])
        mse = explorer.last_value(hist, "loss/mse")
        if mse is None:
            continue
        finals.append(float(mse))
        s = steps_to_converge(hist, float(mse))
        if s is not None:
            speeds.append(s)
    if finals:
        mean_final = sum(finals) / len(finals)
        mean_speed = sum(speeds) / len(speeds) if speeds else float("nan")
        print(
            f"{name}: {len(finals)} runs, mean final MSE {mean_final:.5f}, "
            f"mean steps-to-10% {mean_speed:.0f}"
        )

# %% [markdown]
# ## AuxK comparison: dead latents + reconstruction
# AuxK's job is resurrecting dead latents; the trade is a small MSE tax.

# %%
for name, members in grouped(auxk_key).items():
    dead, nmse = [], []
    for run in members:
        hist = run.get("history", [])
        d = explorer.last_value(hist, "loss/n_dead")
        m = explorer.last_value(hist, "metrics/normalized_mse")
        if d is not None:
            dead.append(float(d))
        if m is not None:
            nmse.append(float(m))
    if dead or nmse:
        mean = lambda xs: sum(xs) / len(xs) if xs else float("nan")
        print(
            f"{name}: {len(members)} runs, mean final dead {mean(dead):.0f}, "
            f"mean NMSE {mean(nmse):.4f}"
        )

# %% [markdown]
# ## Drill down
# `python -m saev_tpu_torch.interactive.metrics metrics --tracker-dir <dir>` renders
# the same runs with filtering and per-run curves.
