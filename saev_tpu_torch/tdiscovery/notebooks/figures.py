"""Paper figures/tables for trait discovery.

The port's copy of `contrib/trait_discovery/notebooks/figures.py`:
the same cells, environment variables, defaults, printed lines and
artifacts, on saev_tpu_torch (no JAX).

Capability mirror of reference contrib/trait_discovery/notebooks/figures.py
(2661-line marimo notebook) as a percent-format script. The coding style is
the reference's own (figures.py:9-46): every figure/table function is
self-contained — build `specs: list[RunSpec]`, call `load_df(specs)`, plot
from the DataFrame, and save BOTH a .pdf and a .csv artifact so each figure is
reproducible from its own CSV. Run ids are explicit constants inside each
function, never globals.

Set TD_RUNS (colon-separated run dirs) and TD_OUT, then run top to bottom, or
import the figure functions and pass specs programmatically.
"""

# %%
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

from saev_tpu_torch.tdiscovery.runs import RunSpec, load_df, pareto_front, shard_columns  # noqa: E402

OUT = pathlib.Path(os.environ.get("TD_OUT", "./figures"))


def _save(fig, df_csv, name: str, out: pathlib.Path = OUT) -> tuple:
    """Every artifact ships as pdf + csv (reference figures.py:27-29)."""
    out.mkdir(parents=True, exist_ok=True)
    pdf = out / f"{name}.pdf"
    csv = out / f"{name}.csv"
    if fig is not None:
        fig.savefig(pdf, bbox_inches="tight")
    df_csv.to_csv(csv, index=False)
    return pdf, csv


# %% [markdown]
# ## Figure: L0 vs normalized-MSE pareto per method
# Each run contributes one point per evaluated shard; frontier runs are
# emphasized and labeled.


# %%
def plot_pareto(specs: list[RunSpec], shard: str, *, name: str = "pareto", out=OUT):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    df, skipped = load_df(specs)
    nmse_col = f"{shard}/normalized_mse"
    l0_col = f"{shard}/trait_mean_ap"  # probe quality axis when present
    have = df.dropna(subset=[nmse_col]) if nmse_col in df else df.iloc[:0]

    fig, ax = plt.subplots(figsize=(5, 4))
    for method, group in have.groupby("method"):
        xs = np.asarray(group[nmse_col], float)
        ys = (
            np.asarray(group[l0_col], float)
            if l0_col in group
            else np.zeros(len(group))
        )
        ax.scatter(xs, ys, label=method, s=24)
        if len(xs) > 1:
            mask = pareto_front(xs, -ys)  # minimize nmse, maximize ap
            for _, row in group[mask].iterrows():
                ax.annotate(row["run_id"], (row[nmse_col], row.get(l0_col, 0)),
                            fontsize=6)
    ax.set_xlabel(f"normalized MSE ({shard})")
    ax.set_ylabel("probe mean AP")
    ax.legend()
    paths = _save(fig, have, name, out)
    return fig, have, skipped, paths


# %% [markdown]
# ## Table: probes vs baselines
# Best run per method with its reconstruction + probe metrics side by side.


# %%
def table_methods(specs: list[RunSpec], shard: str, *, name: str = "methods", out=OUT):
    df, skipped = load_df(specs)
    cols = [c for c in ("run_id", "method", "activation", "d_sae", "lr") if c in df.columns]
    cols += [c for c in (
        f"{shard}/normalized_mse",
        f"{shard}/trait_mean_ap",
        f"{shard}/probe_r",
        f"{shard}/audit_auc_b",
    ) if c in df.columns]
    tidy = df[cols].copy()
    sort_col = f"{shard}/trait_mean_ap"
    if sort_col in tidy.columns:
        tidy = tidy.sort_values(sort_col, ascending=False)
    _save(None, tidy, name, out)
    return tidy, skipped


# %% [markdown]
# ## Table: audit Yield@B across classifiers


# %%
def table_audit(specs: list[RunSpec], shard: str, *, name: str = "audit", out=OUT):
    import json

    import pandas as pd

    rows = []
    for spec in specs:
        fpath = pathlib.Path(spec.run) / "inference" / shard / "audit_results.json"
        if not fpath.exists():
            continue
        audit = json.loads(fpath.read_text())
        for cls in audit["classifiers"]:
            rows.append({
                "run_id": pathlib.Path(spec.run).name,
                "method": spec.method,
                "cls_type": cls["cls_type"],
                "tau": cls["tau"],
                "auc_b": cls["auc_b"],
                **{f"yield@{k}": v for k, v in cls["yield_at_b"].items()},
            })
    tidy = pd.DataFrame(rows)
    _save(None, tidy, name, out)
    return tidy


# %% [markdown]
# ## Drive everything from env vars when run as a script

# %%
if __name__ == "__main__":
    run_dirs = [p for p in os.environ.get("TD_RUNS", "").split(":") if p]
    if not run_dirs:
        print("Set TD_RUNS=<run>:<run>:... and TD_SHARD=<shard hash> to run.")
    else:
        specs = [RunSpec(run=pathlib.Path(p)) for p in run_dirs]
        shard = os.environ.get("TD_SHARD", "")
        if not shard:
            inference = pathlib.Path(run_dirs[0]) / "inference"
            shard = next(p.name for p in inference.iterdir() if p.is_dir())
        _, df, skipped, paths = plot_pareto(specs, shard)
        print(f"pareto: {len(df)} runs plotted, {len(skipped)} skipped -> {paths}")
        tidy, _ = table_methods(specs, shard)
        print(tidy.to_string(index=False))
        audit = table_audit(specs, shard)
        if len(audit):
            print(audit.to_string(index=False))
