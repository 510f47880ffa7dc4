"""Compare activation functions across a trained SAE sweep.

The port's copy of `contrib/trait_discovery/notebooks/001_actfn.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/001_actfn.py
(1286-line marimo notebook: load sweep runs, group by activation function,
plot L0-vs-NMSE pareto frontiers per group, inspect the winners). Marimo is
not a dependency here, so this is a percent-format script — run cells in any
editor, export with scripts/export_notebook.py, or run top to bottom.

Data source: the local JSONL tracker dirs written by training runs with
`--track` off (`.wandb/<project>/<id>/metrics.jsonl`), or wandb if
configured — the same loaders the sweep explorer uses.
"""

# %% [markdown]
# # Activation-function comparison
# Groups a sweep's runs by activation config and compares their L0 / NMSE
# pareto frontiers. Set `TRACKER_DIR` (and optionally `TAG`) first.

# %%
import collections
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.interactive import metrics as explorer

TRACKER_DIR = pathlib.Path(os.environ.get("SAEV_TRACKER", ".wandb/saev"))
TAG = os.environ.get("SAEV_TAG", "")

# %% [markdown]
# ## Load the sweep's runs

# %%
runs = explorer.load_runs_local(TRACKER_DIR, tag=TAG)
print(f"{len(runs)} runs loaded from {TRACKER_DIR}")

# %% [markdown]
# ## Group by activation function

# %%
def actfn_key(run: dict) -> str:
    act = (run.get("config", {}).get("sae") or {}).get("activation") or {}
    key = act.get("key", "?")
    k = act.get("top_k")
    return f"{key}(k={k})" if k is not None else key


groups = collections.defaultdict(list)
for run in runs:
    groups[actfn_key(run)].append(run)
for name, members in sorted(groups.items()):
    print(f"{name}: {len(members)} runs")

# %% [markdown]
# ## Pareto frontier per activation function
# A run is on the frontier if no other run in its group has both lower L0
# and lower normalized MSE.

# %%
def frontier(rows: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    rows = sorted(rows)
    out, best = [], float("inf")
    for l0, nmse, rid in rows:
        if nmse < best:
            out.append((l0, nmse, rid))
            best = nmse
    return out


points = {}
for name, members in groups.items():
    rows = []
    for run in members:
        l0 = explorer.last_value(run.get("history", []), "loss/l0")
        nmse = explorer.last_value(run.get("history", []), "metrics/normalized_mse")
        if l0 is not None and nmse is not None:
            rows.append((float(l0), float(nmse), run.get("id", "?")))
    points[name] = frontier(rows)
    print(f"\n{name} frontier:")
    for l0, nmse, rid in points[name]:
        print(f"  {rid}: L0={l0:8.1f}  NMSE={nmse:.4f}")

# %% [markdown]
# ## Full interactive view
# The sweep explorer renders the same data with run filtering and per-run
# curve drill-down:
#
# ```sh
# python -m saev_tpu_torch.interactive.metrics metrics --tracker-dir <TRACKER_DIR>
# ```
