"""Convert a FishVista download into the dataset layouts the pipeline reads
(counterpart of contrib/trait_discovery/scripts/format_fishvista.py).

Capability mirror of reference contrib/trait_discovery/scripts/
format_fishvista.py (:239 segfolder, :299 imgfolder): FishVista ships as one
Images/ directory plus segmentation_{split}.csv / classification_{split}.csv
manifests; the extraction pipeline wants either the `ImgSegFolder` layout
(`images/<split>/`, `annotations/<split>/`, labels.csv keyed by stem) or the
`ImgFolder` layout (`<split>/<class>/<img>`). The segfolder path optionally
merges a FishBase trait CSV — one-hot habitat/migration columns collapse into
single categoricals, environments into yes/no — and drops images whose
species has no habitat record (with a >50% join-rate sanity gate), exactly
the frame `tdiscovery.fishbase` consumes downstream.

The reference builds the join with polars; this is stdlib csv (no polars),
with the same columns and the same drop/assert semantics.

Usage:
    python -m saev_tpu_torch.tdiscovery.scripts.format_fishvista segfolder \\
        --fv-root data/fish-vista --dump-to data/segfolder \\
        [--fishbase-csv traits.csv]
"""

import concurrent.futures
import csv
import dataclasses
import logging
import pathlib
import shutil

logger = logging.getLogger("format_fishvista")

SEG_SPLITS = {"train": "training", "val": "validation", "test": "test"}
IMG_SPLITS = ("train", "val", "test")

HABITAT_COLS = (
    "reef-associated",
    "pelagic-oceanic",
    "pelagic-neritic",
    "bathypelagic",
    "bathydemersal",
    "benthopelagic",
    "pelagic",
    "epipelagic",
    "mesopelagic",
    "abyssopelagic",
    "demersal",
)

MIGRATION_COLS = (
    "amphidromous",
    "anadromous",
    "catadromous",
    "limnodromous",
    "non-migratory",
    "oceanodromous",
    "potamodromous",
)

ENV_COLS = ("marine", "freshwater", "brackish")

EXTRA_COLS = ("habitat", "migration") + ENV_COLS


@dataclasses.dataclass(frozen=True)
class Config:
    fv_root: pathlib.Path = pathlib.Path("./data/fish-vista")
    """The FishVista download (Images/ + per-split CSVs)."""
    dump_to: pathlib.Path = pathlib.Path("./data/segfolder")
    fishbase_csv: pathlib.Path | None = None
    """FishBase trait CSV (genus,species + one-hot habitat/migration/env)."""
    n_threads: int = 16
    job_size: int = 256
    """Images copied per thread-pool job."""


def _one(value: str) -> bool:
    try:
        return float(value) == 1.0
    except (TypeError, ValueError):  # '', '?', None
        return False


def collapse_fishbase_row(row: dict[str, str]) -> dict[str, str]:
    """One-hot trait columns -> categoricals: the first vocab-order column at
    1.0 wins (polars coalesce semantics); environments become yes/no."""
    out = {"habitat": "", "migration": ""}
    for col in HABITAT_COLS:
        if _one(row.get(col, "")):
            out["habitat"] = col
            break
    for col in MIGRATION_COLS:
        if _one(row.get(col, "")):
            out["migration"] = col
            break
    for col in ENV_COLS:
        out[col] = "yes" if _one(row.get(col, "")) else "no"
    return out


def load_fishbase(fpath: pathlib.Path) -> dict[tuple[str, str], dict[str, str]]:
    assert fpath.is_file(), f"FishBase CSV not found: {fpath}"
    table: dict[tuple[str, str], dict[str, str]] = {}
    with open(fpath, newline="") as fd:
        reader = csv.DictReader(fd)
        cols = set(reader.fieldnames or [])
        for required in ("genus", "species"):
            assert required in cols, f"FishBase CSV missing '{required}' column"
        missing = (set(HABITAT_COLS) | set(MIGRATION_COLS) | set(ENV_COLS)) - cols
        assert not missing, f"FishBase CSV missing columns: {sorted(missing)}"
        for row in reader:
            key = (row["genus"].strip().lower(), row["species"].strip().lower())
            table[key] = collapse_fishbase_row(row)
    return table


def _seg_rows(fv_root: pathlib.Path) -> list[dict[str, str]]:
    """stem/family/genus/species across all segmentation splits. FishVista's
    standardized_species is 'Genus species...'; FishBase keys on lowercase
    genus + species epithet (reference :123-140)."""
    rows = []
    for fv_split in SEG_SPLITS:
        fpath = fv_root / f"segmentation_{fv_split}.csv"
        assert fpath.is_file(), f"FishVista segmentation CSV not found: {fpath}"
        with open(fpath, newline="") as fd:
            reader = csv.DictReader(fd)
            cols = set(reader.fieldnames or [])
            for required in ("filename", "family", "standardized_species"):
                assert required in cols, f"FishVista CSV missing '{required}'"
            for row in reader:
                words = row["standardized_species"].split()
                rows.append({
                    "stem": pathlib.Path(row["filename"]).stem,
                    "family": row["family"],
                    "genus": words[0].lower() if words else "",
                    # The species EPITHET is the second word; trinomials'
                    # subspecies suffix must not enter the FishBase join key
                    # (scrape_fishbase keys on parts[1] too).
                    "species": words[1].lower() if len(words) > 1 else "",
                })
    return rows


def write_labels_csv(cfg: Config) -> set[str]:
    """labels.csv under dump_to; returns the valid stems (those kept after
    the optional FishBase habitat filter)."""
    rows = _seg_rows(cfg.fv_root)
    header = ["stem", "family", "genus", "species"]

    if cfg.fishbase_csv is None:
        logger.info("No FishBase CSV; labels.csv without trait fields.")
    else:
        table = load_fishbase(cfg.fishbase_csv)
        header += list(EXTRA_COLS)
        joined = []
        for row in rows:
            extras = table.get((row["genus"], row["species"]))
            if extras is None or not extras["habitat"]:
                continue
            joined.append({**row, **extras})
        match_pct = 100 * len(joined) / max(len(rows), 1)
        logger.info(
            "FishBase join: %d/%d matched (%.1f%%), dropped %d without habitat",
            len(joined), len(rows), match_pct, len(rows) - len(joined),
        )
        assert match_pct > 50, (
            f"FishBase join matched only {match_pct:.1f}%, expected >50%"
        )
        assert joined, "No images left after filtering for habitat data"
        rows = joined

    cfg.dump_to.mkdir(parents=True, exist_ok=True)
    with open(cfg.dump_to / "labels.csv", "w", newline="") as fd:
        writer = csv.DictWriter(fd, fieldnames=header)
        writer.writeheader()
        writer.writerows(rows)
    return {row["stem"] for row in rows}


def _manifest(fv_root: pathlib.Path, kind: str, split: str) -> list[dict[str, str]]:
    with open(fv_root / f"{kind}_{split}.csv", newline="") as fd:
        return list(csv.DictReader(fd))


def _cp_seg(cfg: Config, valid: set[str], rows: list[dict[str, str]],
            tgt_split: str) -> None:
    for row in rows:
        fname = row["filename"]
        stem = pathlib.Path(fname).stem
        if stem not in valid:
            continue
        src = cfg.fv_root / "Images" / fname
        if not src.exists():
            logger.warning("Missing image '%s'", src)
            continue
        dst = cfg.dump_to / "images" / tgt_split / fname
        if not dst.exists():
            shutil.copy2(src, dst)
        seg_src = cfg.fv_root / "segmentation_masks" / "images" / f"{stem}.png"
        seg_dst = cfg.dump_to / "annotations" / tgt_split / f"{stem}.png"
        if seg_src.exists() and not seg_dst.exists():
            shutil.copy2(seg_src, seg_dst)


def segfolder(cfg: Config) -> int:
    """FishVista -> ImgSegFolder layout (+labels.csv, optional trait merge)."""
    from ... import helpers

    for tgt_split in SEG_SPLITS.values():
        (cfg.dump_to / "images" / tgt_split).mkdir(parents=True, exist_ok=True)
        (cfg.dump_to / "annotations" / tgt_split).mkdir(parents=True, exist_ok=True)

    valid = write_labels_csv(cfg)
    logger.info("Found %d valid stems.", len(valid))

    with concurrent.futures.ThreadPoolExecutor(cfg.n_threads) as pool:
        futs = []
        for fv_split, tgt_split in SEG_SPLITS.items():
            # Parse the manifest ONCE per split and hand each job its row
            # slice (re-parsing the whole CSV inside every job is O(n^2)).
            rows = _manifest(cfg.fv_root, "segmentation", fv_split)
            futs += [
                pool.submit(_cp_seg, cfg, valid, rows[s:e], tgt_split)
                for s, e in helpers.batched_idx(len(rows), cfg.job_size)
            ]
        for fut in concurrent.futures.as_completed(futs):
            if err := fut.exception():
                logger.warning("Exception: %s", err)
    return 0


def _cp_img(cfg: Config, split: str, rows: list[dict[str, str]]) -> None:
    for row in rows:
        src = cfg.fv_root / "Images" / row["filename"]
        if not src.exists():
            logger.warning("Missing image '%s'", src)
            continue
        dst = cfg.dump_to / split / row["standardized_species"] / row["filename"]
        if not dst.exists():
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src, dst)


def imgfolder(cfg: Config) -> int:
    """FishVista -> ImgFolder layout (<split>/<species>/<img>)."""
    from ... import helpers

    with concurrent.futures.ThreadPoolExecutor(cfg.n_threads) as pool:
        futs = []
        for split in IMG_SPLITS:
            (cfg.dump_to / split).mkdir(parents=True, exist_ok=True)
            rows = _manifest(cfg.fv_root, "classification", split)
            futs += [
                pool.submit(_cp_img, cfg, split, rows[s:e])
                for s, e in helpers.batched_idx(len(rows), cfg.job_size)
            ]
        for fut in concurrent.futures.as_completed(futs):
            if err := fut.exception():
                logger.warning("Exception: %s", err)
    return 0


def main(argv: list[str] | None = None) -> None:
    from ...utils import cli

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
    cli.run({"segfolder": segfolder, "imgfolder": imgfolder}, argv)


if __name__ == "__main__":
    main()
