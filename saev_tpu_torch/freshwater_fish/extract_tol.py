"""Extract fish images from a TreeOfLife-200M-style store into the ImgFolder
layout (counterpart of contrib/freshwater_fish/scripts/extract_tol.py).

Capability mirror of reference contrib/freshwater_fish/scripts/extract_tol.py
(:1-352): the TOL store keeps resolved taxa as per-source parquet files
(`source=<name>/*.parquet` with uuid + taxonomy columns), a uuid -> h5_file
lookup table (parquet), and the image bytes inside HDF5 files under an
`images/<uuid>` dataset. This script filters taxa (by taxa file, class, or
orders), resolves uuids to h5 files, and extracts matching images in parallel
into `<output>/<label>/<uuid>.jpg` — the ImgFolder layout the shard extractor
consumes.

pyarrow only (no polars); taxa CSVs parse with the stdlib.

Usage:
    python -m saev_tpu_torch.freshwater_fish.extract_tol extract \\
        --order-filter Cypriniformes,Perciformes \\
        --resolved-taxa-dpath .../resolved_taxa \\
        --lookup-tables-dpath .../lookup_tables \\
        --output-dpath data/fish
"""

import concurrent.futures
import csv
import dataclasses
import io
import logging
import pathlib

from .. import helpers

logger = logging.getLogger("fish.extract_tol")

TAXA_MATCH_COLS = ("family", "genus", "species")


@dataclasses.dataclass(frozen=True)
class Config:
    taxa_file: pathlib.Path | None = None
    """CSV/parquet with taxa to keep (any subset of family/genus/species
    columns). Overrides class_filter/order_filter when given."""
    class_filter: str = ""
    """Taxonomic class to filter by (e.g. 'Actinopterygii')."""
    order_filter: tuple[str, ...] = ()
    """Taxonomic orders to filter by (e.g. 'Cypriniformes')."""
    resolved_taxa_dpath: pathlib.Path = pathlib.Path("./resolved_taxa")
    """Directory with source=<name>/ parquet partitions of resolved taxa."""
    lookup_tables_dpath: pathlib.Path = pathlib.Path("./lookup_tables")
    """Directory with uuid -> h5_file parquet lookup tables."""
    output_dpath: pathlib.Path = pathlib.Path("data/freshwater-fish")
    """ImgFolder output root."""
    label_column: str = "species"
    """Taxonomic rank used as the class-folder name."""
    n_workers: int = 16
    """Parallel h5 extraction workers."""
    sources: tuple[str, ...] = ("gbif", "eol", "fathomnet", "bioscan")
    """TOL sources to include."""
    jpeg_quality: int = 95


def load_taxa_filter(fpath: pathlib.Path) -> tuple[str, set[str]]:
    """(filter column, allowed values) from a taxa CSV/parquet: the first of
    family/genus/species present (reference TaxaFilter.load :92-114)."""
    if fpath.suffix == ".parquet":
        pq = helpers.optional_import("pyarrow.parquet", "freshwater_fish.extract_tol")

        table = pq.read_table(fpath)
        cols = {c.lower(): c for c in table.column_names}
        for want in TAXA_MATCH_COLS:
            if want in cols:
                values = {
                    str(v) for v in table[cols[want]].to_pylist() if v is not None
                }
                return want, values
    else:
        with open(fpath, newline="") as fd:
            reader = csv.DictReader(fd)
            fields = {f.lower(): f for f in reader.fieldnames or []}
            for want in TAXA_MATCH_COLS:
                if want in fields:
                    values = {row[fields[want]] for row in reader if row[fields[want]]}
                    return want, values
    raise ValueError(
        f"Taxa file {fpath} must have at least one of {TAXA_MATCH_COLS}."
    )


def collect_pairs(cfg: Config) -> list[tuple[str, str]]:
    """(uuid, label) pairs across sources after filtering (reference
    load_and_filter_source_pyarrow :168-228)."""
    pa = helpers.optional_import("pyarrow", "freshwater_fish.extract_tol")
    pc = helpers.optional_import("pyarrow.compute", "freshwater_fish.extract_tol")
    pq = helpers.optional_import("pyarrow.parquet", "freshwater_fish.extract_tol")

    filter_col: str | None = None
    filter_values = None
    if cfg.taxa_file is not None:
        filter_col, allowed = load_taxa_filter(cfg.taxa_file)
        filter_values = pa.array(sorted(allowed))
    elif cfg.class_filter:
        filter_col, filter_values = "class", pa.array([cfg.class_filter])
    elif cfg.order_filter:
        filter_col, filter_values = "order", pa.array(list(cfg.order_filter))

    pairs: list[tuple[str, str]] = []
    for source in cfg.sources:
        source_dpath = cfg.resolved_taxa_dpath / f"source={source}"
        if not source_dpath.exists():
            logger.warning("Source directory not found: %s", source_dpath)
            continue
        for fpath in sorted(source_dpath.glob("*.parquet")):
            cols = ["uuid", cfg.label_column]
            if filter_col and filter_col not in cols:
                cols.append(filter_col)
            table = pq.read_table(fpath, columns=cols)
            if filter_col is not None:
                table = table.filter(
                    pc.is_in(table[filter_col], value_set=filter_values)
                )
            table = table.filter(pc.is_valid(table[cfg.label_column]))
            if table.num_rows:
                pairs.extend(
                    zip(
                        table["uuid"].to_pylist(),
                        (str(v) for v in table[cfg.label_column].to_pylist()),
                    )
                )
        logger.info("After %s: %d pairs.", source, len(pairs))
    return pairs


def load_lookup(dpath: pathlib.Path, uuids: set[str]) -> dict[str, str]:
    """uuid -> h5_file for the requested uuids (reference
    load_lookup_tables_pyarrow :117-139)."""
    pa = helpers.optional_import("pyarrow", "freshwater_fish.extract_tol")
    pc = helpers.optional_import("pyarrow.compute", "freshwater_fish.extract_tol")
    pq = helpers.optional_import("pyarrow.parquet", "freshwater_fish.extract_tol")

    uuid_array = pa.array(sorted(uuids))
    out: dict[str, str] = {}
    for fpath in sorted(pathlib.Path(dpath).glob("*.parquet")):
        table = pq.read_table(fpath, columns=["uuid", "h5_file"])
        table = table.filter(pc.is_in(table["uuid"], value_set=uuid_array))
        for uuid, h5_file in zip(
            table["uuid"].to_pylist(), table["h5_file"].to_pylist()
        ):
            out[uuid] = h5_file
    logger.info("Resolved %d/%d uuids via lookup tables.", len(out), len(uuids))
    return out


def extract_h5_file(
    h5_fpath: pathlib.Path,
    tasks: list[tuple[str, pathlib.Path]],
    jpeg_quality: int,
) -> int:
    """Save every requested uuid from one h5 file; returns success count
    (reference extract_h5_file :142-165)."""
    h5py = helpers.optional_import("h5py", "freshwater_fish.extract_tol")
    image = helpers.optional_import("PIL.Image", "freshwater_fish.extract_tol")

    n_success = 0
    try:
        with h5py.File(h5_fpath, "r") as fd:
            images = fd["images"]
            for uuid, out_fpath in tasks:
                try:
                    if uuid not in images:
                        continue
                    img = image.open(io.BytesIO(bytes(images[uuid][:])))
                    if img.mode != "RGB":
                        img = img.convert("RGB")
                    out_fpath.parent.mkdir(parents=True, exist_ok=True)
                    img.save(out_fpath, "JPEG", quality=jpeg_quality)
                    n_success += 1
                except Exception as err:
                    logger.warning("Failed to extract %s: %s", uuid, err)
    except Exception as err:
        logger.warning("Failed to open %s: %s", h5_fpath, err)
    return n_success


def worker_fn(cfg: Config) -> int:
    """Filter -> resolve -> extract. Returns the number of images written."""
    pairs = collect_pairs(cfg)
    if not pairs:
        logger.warning("No matching images found. Check your filter settings.")
        return 0

    uuid_to_label = dict(pairs)
    uuid_to_h5 = load_lookup(cfg.lookup_tables_dpath, set(uuid_to_label))

    by_h5: dict[pathlib.Path, list[tuple[str, pathlib.Path]]] = {}
    n_skipped = 0
    for uuid, h5_file in uuid_to_h5.items():
        label_safe = uuid_to_label[uuid].replace("/", "_").replace(" ", "_")
        out_fpath = cfg.output_dpath / label_safe / f"{uuid}.jpg"
        if out_fpath.exists():
            n_skipped += 1
            continue
        by_h5.setdefault(pathlib.Path(h5_file), []).append((uuid, out_fpath))

    n_tasks = sum(len(t) for t in by_h5.values())
    logger.info(
        "Prepared %d tasks across %d h5 files (skipped %d existing).",
        n_tasks, len(by_h5), n_skipped,
    )
    if not by_h5:
        return 0

    n_total = 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=cfg.n_workers) as pool:
        futures = [
            pool.submit(extract_h5_file, h5_path, tasks, cfg.jpeg_quality)
            for h5_path, tasks in by_h5.items()
        ]
        for fut in concurrent.futures.as_completed(futures):
            n_total += fut.result()
    logger.info("Extraction complete: %d images in %s.", n_total, cfg.output_dpath)
    return n_total


def extract(cfg: Config) -> None:
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
    worker_fn(cfg)


def main(argv: list[str] | None = None) -> None:
    from ..utils import cli

    cli.run({"extract": extract}, argv)


if __name__ == "__main__":
    main()
