"""Download the Cambridge butterfly (Heliconius) dataset into ImgSegFolder
(counterpart of contrib/trait_discovery/scripts/download_butterflies.py).

Capability mirror of reference contrib/trait_discovery/scripts/
download_butterflies.py (:242 main): pull the cambridge-segfolder dataset
from HuggingFace and materialize it as `images/<split>/<stem>.jpg` +
`annotations/<split>/<stem>.png` + labels.csv whose columns include the
compound `subspecies_view` label (e.g. "lativitta_dorsal") that the mimicry
pair tasks group on (`tdiscovery.mimicry.pair_task`).

The conversion (`materialize`) is separated from the network fetch so it runs
hermetically on any sequence of {image, mask, subspecies, view[, stem]} rows.

Usage:
    python -m saev_tpu_torch.tdiscovery.scripts.download_butterflies fetch \\
        --out data/cambridge-segfolder
"""

import csv
import dataclasses
import io
import itertools
import logging
import pathlib

from ... import helpers

logger = logging.getLogger("download_butterflies")

IMAGE_COL_ALIASES = ("image", "img", "photo", "picture")
MASK_COL_ALIASES = ("mask", "segmentation", "seg", "annotation")


@dataclasses.dataclass(frozen=True)
class Config:
    hf_dataset: str = "samuelstevens/cambridge-segfolder"
    revision: str = "v1.2"
    out: pathlib.Path = pathlib.Path("./data/cambridge-segfolder")
    split: str = "train"
    """HF split to download."""
    target_split: str = "training"
    """ImgSegFolder split name (training or validation)."""
    image_col: str = "image"
    mask_col: str = "mask"
    label_cols: tuple[str, ...] = ("subspecies", "view")
    stem_col: str | None = "stem"
    """Column naming each example; None -> zero-padded index stems."""


def find_column(cols: set[str], primary: str, aliases: tuple[str, ...]) -> str:
    """Resolve a column name, trying aliases when the primary is absent."""
    if primary in cols:
        return primary
    for alias in aliases:
        if alias in cols:
            logger.info("Using column '%s' for '%s'.", alias, primary)
            return alias
    raise ValueError(
        f"Column '{primary}' not found. Available: {', '.join(sorted(cols))}"
    )


def extract_pil_image(data):
    """PIL image from the formats HF datasets hand back: PIL, {'bytes'},
    {'path'}, or raw bytes."""
    image = helpers.optional_import("PIL.Image", "download_butterflies")
    if isinstance(data, image.Image):
        return data
    if isinstance(data, dict) and "bytes" in data and data["bytes"]:
        return image.open(io.BytesIO(data["bytes"]))
    if isinstance(data, dict) and "path" in data:
        return image.open(data["path"])
    if isinstance(data, bytes):
        return image.open(io.BytesIO(data))
    raise ValueError(f"Unknown image format: {type(data)}")


def materialize(cfg: Config, rows) -> dict[str, int]:
    """Write images/annotations/labels.csv from an iterable of row dicts.
    Duplicate stems keep their first labels row; existing files are skipped
    (resumability). Returns counts."""
    img_dir = cfg.out / "images" / cfg.target_split
    ann_dir = cfg.out / "annotations" / cfg.target_split
    img_dir.mkdir(parents=True, exist_ok=True)
    ann_dir.mkdir(parents=True, exist_ok=True)

    header = ["stem", *cfg.label_cols, "subspecies_view"]
    label_rows: list[list[str]] = []
    seen: set[str] = set()
    n_written = n_skipped = 0

    # Stream rows one at a time — list(rows) on an HF dataset decodes EVERY
    # image+mask into memory at once; only the first row is needed to resolve
    # the column names.
    it = iter(rows)
    try:
        first = next(it)
    except StopIteration:
        first = None
    cols: set[str] = set(first.keys()) if first is not None else set()
    image_col = find_column(cols, cfg.image_col, IMAGE_COL_ALIASES)
    mask_col = find_column(cols, cfg.mask_col, MASK_COL_ALIASES)

    row_stream = [] if first is None else itertools.chain([first], it)
    for i, row in enumerate(row_stream):
        if cfg.stem_col and cfg.stem_col in row:
            stem = pathlib.Path(str(row[cfg.stem_col])).stem
        else:
            stem = f"{i:08d}"

        if stem not in seen:
            seen.add(stem)
            values = [stem]
            for col in cfg.label_cols:
                assert col in row, f"Label column '{col}' not in dataset."
                values.append(str(row[col]))
            subspecies = str(row.get("subspecies", ""))
            view = str(row.get("view", "unknown"))
            values.append(f"{subspecies}_{view}")
            label_rows.append(values)

        img_fpath = img_dir / f"{stem}.jpg"
        mask_fpath = ann_dir / f"{stem}.png"
        if img_fpath.exists() and mask_fpath.exists():
            n_skipped += 1
            continue
        try:
            if not img_fpath.exists():
                extract_pil_image(row[image_col]).convert("RGB").save(img_fpath)
            if not mask_fpath.exists():
                extract_pil_image(row[mask_col]).save(mask_fpath)
            n_written += 1
        except Exception as err:
            logger.warning("Failed to process %s: %s", stem, err)

    # Merge with any existing labels.csv (fetching split=train then
    # split=validation must not clobber the first split's rows; this run's
    # values win for re-fetched stems).
    labels_fpath = cfg.out / "labels.csv"
    merged: dict[str, list[str]] = {}
    if labels_fpath.exists():
        with open(labels_fpath, newline="") as fd:
            reader = csv.reader(fd)
            old_header = next(reader, None)
            if old_header == header:
                for row in reader:
                    merged[row[0]] = row
            else:
                logger.warning(
                    "labels.csv header changed (%s -> %s); rewriting.",
                    old_header, header,
                )
    for row in label_rows:
        merged[row[0]] = row
    with open(labels_fpath, "w", newline="") as fd:
        writer = csv.writer(fd)
        writer.writerow(header)
        writer.writerows(merged.values())
    logger.info(
        "Wrote %d labels, %d images (%d skipped, %d duplicate stems).",
        len(label_rows), n_written, n_skipped, len(rows) - len(label_rows),
    )
    return {"labels": len(label_rows), "written": n_written, "skipped": n_skipped}


def fetch(cfg: Config) -> dict[str, int]:
    """Download from HuggingFace and materialize (network)."""
    datasets = helpers.optional_import("datasets", "download_butterflies.fetch")

    logger.info("Downloading %s (revision=%s).", cfg.hf_dataset, cfg.revision)
    ds = datasets.load_dataset(cfg.hf_dataset, split=cfg.split,
                               revision=cfg.revision)
    return materialize(cfg, ds)


def main(argv: list[str] | None = None) -> None:
    from ...utils import cli

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
    cli.run({"fetch": fetch}, argv)


if __name__ == "__main__":
    main()
