"""Format an ADE20K download into the ImgSegFolder layout (counterpart of
contrib/trait_discovery/scripts/format_ade20k.py).

Capability mirror of reference contrib/trait_discovery/scripts/
format_ade20k.py (:192 main): validate that image, annotation, and label
stems line up across the training/validation splits, derive per-image scene
labels from labels.csv (preferred) or sceneCategories.txt, write the
normalized `image_labels.txt`, and — when the destination differs from the
source — materialize the tree via symlink / hardlink / copy with a thread
pool. In-place runs only write the label file.

Usage:
    python -m saev_tpu_torch.tdiscovery.scripts.format_ade20k format \\
        --src-root data/ADEChallengeData2016 [--dump-to data/segfolder] \\
        [--link-mode symlink]
"""

import concurrent.futures
import csv
import dataclasses
import logging
import os
import pathlib
import shutil
import typing as tp

logger = logging.getLogger("format_ade20k")

SPLITS = ("training", "validation")
SUBDIRS = ("images", "annotations")


@dataclasses.dataclass(frozen=True)
class Config:
    src_root: pathlib.Path = pathlib.Path("./data/ADEChallengeData2016")
    """Raw ADE20K root with images/, annotations/, and sceneCategories.txt."""
    dump_to: pathlib.Path | None = None
    """Destination root; None formats in place (labels file only)."""
    scene_categories_fname: str = "sceneCategories.txt"
    labels_csv_fname: str = "labels.csv"
    """Preferred label source when present (columns: stem,<label_col>)."""
    label_col: str = "scene"
    image_labels_fname: str = "image_labels.txt"
    link_mode: tp.Literal["symlink", "hardlink", "copy"] = "symlink"
    n_threads: int = 16
    job_size: int = 1024


def read_labels(cfg: Config) -> dict[str, str]:
    """stem -> scene label, from labels.csv if present else the space-
    separated sceneCategories.txt (stems may contain spaces only in the
    label-free prefix, so rpartition; reference :49-88)."""
    labels: dict[str, str] = {}
    csv_fpath = cfg.src_root / cfg.labels_csv_fname
    if csv_fpath.is_file():
        with open(csv_fpath, newline="") as fd:
            reader = csv.DictReader(fd)
            assert reader.fieldnames and reader.fieldnames[0] == "stem", (
                f"First column of {csv_fpath} must be 'stem'"
            )
            assert cfg.label_col in reader.fieldnames, (
                f"Missing label column '{cfg.label_col}' in {csv_fpath}"
            )
            for row in reader:
                stem, label = row["stem"], row[cfg.label_col]
                assert stem and label, f"Empty stem/label in {csv_fpath}"
                assert stem not in labels, f"Duplicate stem '{stem}'"
                labels[stem] = label
        return labels

    scene_fpath = cfg.src_root / cfg.scene_categories_fname
    assert scene_fpath.is_file(), f"Missing scene categories file: {scene_fpath}"
    for line in scene_fpath.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        stem, _, label = line.rpartition(" ")
        assert stem and label, f"Malformed line in {scene_fpath}: '{line}'"
        assert stem not in labels, f"Duplicate stem '{stem}'"
        labels[stem] = label
    return labels


def _stems(root: pathlib.Path) -> set[str]:
    out: set[str] = set()
    for split in SPLITS:
        split_dir = root / split
        if split_dir.is_dir():
            out |= {p.stem for p in split_dir.rglob("*") if p.is_file()}
    return out


def _materialize(cfg: Config, pairs: list[tuple[pathlib.Path, pathlib.Path]]):
    from ... import helpers

    def link_batch(start: int, end: int) -> None:
        for src, dst in pairs[start:end]:
            if dst.exists():
                continue
            dst.parent.mkdir(parents=True, exist_ok=True)
            if cfg.link_mode == "copy":
                shutil.copy2(src, dst)
            elif cfg.link_mode == "hardlink":
                os.link(src, dst)
            else:
                os.symlink(src, dst)

    with concurrent.futures.ThreadPoolExecutor(cfg.n_threads) as pool:
        futs = [
            pool.submit(link_batch, s, e)
            for s, e in helpers.batched_idx(len(pairs), cfg.job_size)
        ]
        for fut in concurrent.futures.as_completed(futs):
            if err := fut.exception():
                logger.warning("Exception: %s", err)


def format_ade20k(cfg: Config) -> int:
    """Validate stem alignment, write image_labels.txt, materialize the tree
    when dump_to differs from src_root."""
    assert cfg.src_root.is_dir(), f"Missing source root: {cfg.src_root}"
    dump_to = cfg.dump_to or cfg.src_root

    labels = read_labels(cfg)
    assert labels, "No labels found for ADE20K"

    img_stems = _stems(cfg.src_root / "images")
    ann_stems = _stems(cfg.src_root / "annotations")
    assert img_stems, "No images found under images/"
    assert ann_stems, "No annotations found under annotations/"
    assert img_stems == set(labels), (
        f"Image stems ({len(img_stems)}) != label stems ({len(labels)})"
    )
    assert ann_stems == img_stems, (
        f"Annotation stems ({len(ann_stems)}) != image stems ({len(img_stems)})"
    )

    out_fpath = dump_to / cfg.image_labels_fname
    out_fpath.parent.mkdir(parents=True, exist_ok=True)
    with open(out_fpath, "w") as fd:
        for stem, label in sorted(labels.items()):
            fd.write(f"{stem} {label}\n")
    logger.info("Wrote %d labels to %s", len(labels), out_fpath)

    if dump_to == cfg.src_root:
        logger.info("In-place formatting at %s", dump_to)
        return 0

    pairs = []
    for subdir in SUBDIRS:
        for split in SPLITS:
            src_dir = cfg.src_root / subdir / split
            if not src_dir.is_dir():
                continue
            (dump_to / subdir / split).mkdir(parents=True, exist_ok=True)
            for src in src_dir.rglob("*"):
                if src.is_file():
                    rel = src.relative_to(src_dir)
                    pairs.append((src, dump_to / subdir / split / rel))
    logger.info("Materializing %d files via %s into %s",
                len(pairs), cfg.link_mode, dump_to)
    _materialize(cfg, pairs)
    return 0


def main(argv: list[str] | None = None) -> None:
    from ...utils import cli

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
    cli.run({"format": format_ade20k}, argv)


if __name__ == "__main__":
    main()
