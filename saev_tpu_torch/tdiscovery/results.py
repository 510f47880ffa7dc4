"""FishVista results-directory analysis: Result JSONs -> a long frame -> tables
(counterpart of contrib/trait_discovery/src/tdiscovery/results.py).

Capability mirror of reference contrib/trait_discovery/notebooks/results.py:
load every `Result` JSON in a results directory (prefix-filtered), explode the
per-class AP lists into one row per (result, class), unnest the `extra`
provenance column, and build the grouped-mAP and best-latent tables the
reference derives interactively (plus its CUB attributes loader).
"""

import dataclasses
import json
import logging
import pathlib

import numpy as np

from .. import helpers

logger = logging.getLogger("tdiscovery.results")

# FishVista trait-segmentation class names (reference notebooks/results.py
# markdown table; class 0 is background/body).
FISHVISTA_CLASS_NAMES = (
    "background",
    "head",
    "eye",
    "dorsal-fin",
    "pectoral-fin",
    "pelvic-fin",
    "anal-fin",
    "caudal-fin",
    "adipose-fin",
    "barbel",
)


@dataclasses.dataclass(frozen=True)
class CubAttribute:
    """One CUB-200-2011 attribute (reference notebooks/results.py
    load_cub_attributes: `attributes.txt` lines are `<idx> <name>::<value>`)."""

    idx: int
    name: str
    value: str


def load_cub_attributes(fpath: pathlib.Path | str) -> list[CubAttribute]:
    """Parse CUB_200_2011 `attributes.txt` into typed attributes. `idx` is
    the file's own attribute id (1-based in CUB; image_attribute_labels.txt
    joins against it), NOT a line counter."""
    attributes = []
    with open(fpath) as fd:
        for line in fd:
            line = line.strip()
            if not line:
                continue
            raw_idx, attr_raw = line.split(maxsplit=1)
            name, value = attr_raw.split("::", maxsplit=1)
            attributes.append(CubAttribute(int(raw_idx), name, value))
    return attributes


def load_results_df(root: pathlib.Path | str, prefix: str = ""):
    """Long-format dataframe over a results directory: one row per
    (result file, segmentation class) with the test AP as
    `average_precision`, the train AP, the best prototype index, the Result
    scalars, and the unnested `extra` provenance columns (reference
    results.py load_df + unnest('extra'))."""
    pd = helpers.optional_import("pandas", "tdiscovery.results")

    root = pathlib.Path(root)
    rows = []
    for fpath in sorted(root.glob("*.json")):
        if not fpath.name.startswith(prefix):
            continue
        try:
            payload = json.loads(fpath.read_text())
        except json.JSONDecodeError as err:
            logger.warning("Skipping %s: %s", fpath.name, err)
            continue
        results = payload if isinstance(payload, list) else [payload]
        for result in results:
            base = {
                "file": fpath.name,
                "method": result["method"],
                "n_prototypes": int(result["n_prototypes"]),
                "mean_ap": float(result["mean_ap"]),
                "n_train_patches": int(result["n_train_patches"]),
                "n_test_patches": int(result["n_test_patches"]),
                "seed": int(result["seed"]),
                **{
                    str(k): v for k, v in (result.get("extra") or {}).items()
                },
            }
            per_class = zip(
                result["best_prototype_per_class"],
                result["train_ap_per_class"],
                result["test_ap_per_class"],
            )
            for class_idx, (proto, train_ap, test_ap) in enumerate(per_class):
                rows.append({
                    **base,
                    "class_idx": class_idx,
                    "class_name": (
                        FISHVISTA_CLASS_NAMES[class_idx]
                        if class_idx < len(FISHVISTA_CLASS_NAMES)
                        else str(class_idx)
                    ),
                    "best_prototype_idx": int(proto),
                    "train_ap": float(train_ap),
                    "average_precision": float(test_ap),
                })
    df = pd.DataFrame(rows)
    logger.info("Loaded %d per-class rows from %s.", len(df), root)
    return df


def map_table(df, group_cols: list[str] | tuple[str, ...] = ("method", "n_prototypes")):
    """Grouped mAP: mean test AP over classes within each group, sorted
    descending (reference results.py's group_by(...).agg(mean AP))."""
    cols = [c for c in group_cols if c in df.columns]
    out = (
        df.dropna(subset=["average_precision"])
        .groupby(cols, dropna=False)["average_precision"]
        .mean()
        .reset_index()
        .rename(columns={"average_precision": "mAP"})
        .sort_values("mAP", ascending=False)
        .reset_index(drop=True)
    )
    return out


def best_latents(df, *, method: str | None = None, min_train_patches: int = 0):
    """Per-class best prototype summary — the reference's hand-curated
    markdown table ('Segmentation Class | Best Latent | mAP'), derived: for
    each class, the row with the highest test AP (optionally restricted to
    one method / a minimum train-set size)."""
    sub = df
    if method is not None:
        sub = sub[sub["method"] == method]
    if min_train_patches:
        sub = sub[sub["n_train_patches"] >= min_train_patches]
    sub = sub.dropna(subset=["average_precision"])
    if not len(sub):
        return sub
    idx = sub.groupby("class_idx")["average_precision"].idxmax()
    cols = [
        "class_idx", "class_name", "best_prototype_idx", "average_precision",
        "train_ap", "method", "n_prototypes", "file",
    ]
    return sub.loc[idx, [c for c in cols if c in sub.columns]].sort_values(
        "class_idx"
    ).reset_index(drop=True)


def method_vs_random(df, *, n_prototypes: int | None = None):
    """Per-class AP of every method against the matched random baseline
    (reference results.py's manual filter cells, systematized): pivot to one
    column per method, plus the per-class delta vs 'random' when present."""
    sub = df.dropna(subset=["average_precision"])
    if n_prototypes is not None:
        sub = sub[sub["n_prototypes"] == n_prototypes]
    pivot = sub.pivot_table(
        index=["class_idx", "class_name"],
        columns="method",
        values="average_precision",
        aggfunc="max",
    ).reset_index()
    pivot.columns.name = None
    if "random" in pivot.columns:
        for col in [c for c in pivot.columns if c not in (
            "class_idx", "class_name", "random")]:
            pivot[f"{col}_minus_random"] = pivot[col] - pivot["random"]
    return pivot
