"""Trait-discovery dataset wrappers with metadata access (counterpart of
contrib/trait_discovery/src/tdiscovery/datasets.py; reference Butterflies
:15, MetadataDataset :24, ButterfliesDataset :60): segmentation datasets
whose per-image scientific metadata (subspecies, view, locality, ...) is
queryable WITHOUT loading the image, so downstream task construction (mimics
pair specs, classification label groupings) runs over metadata only.

The metadata sheet is read with the stdlib `csv` module and joined onto the
port's `ImgSegFolderDataset` by image filename. Host-only.
"""

import abc
import csv
import dataclasses
import logging
import pathlib
import typing as tp

from ..data import datasets as core_datasets

logger = logging.getLogger("tdiscovery.datasets")

# Columns of the Heliconius master sheet that are never useful downstream
# (reference datasets.py:62-78).
DEAD_COLS = frozenset({
    "file_url", "zenodo_name", "zenodo_link", "X", "Sequence",
    "Sample_accession", "Collected_by", "Other_ID", "Date", "Store",
    "Brood", "Death_Date", "file_type", "record_number",
})


@dataclasses.dataclass(frozen=True)
class Butterflies:
    """Heliconius butterfly segmentation dataset (reference datasets.py:15-21)."""

    root: pathlib.Path = pathlib.Path("data") / "butterflies"
    """Where the segmentation dataset is stored."""
    split: str = "training"
    metadata_csv: str = "Heliconius_img_master.csv"
    """Master metadata sheet; must have an Image_name column."""


Config = Butterflies


class MetadataDataset(abc.ABC):
    """Datasets that provide per-example metadata without loading images
    (reference datasets.py:24-38)."""

    @abc.abstractmethod
    def get_metadata(self, index: int) -> dict:
        """Metadata for the example at `index` (at minimum `label` and
        `target`) without touching image bytes."""
        raise NotImplementedError()

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def __getitem__(self, index: int) -> dict: ...


class ButterfliesDataset(MetadataDataset):
    """ImgSegFolder samples joined with the Heliconius master sheet by image
    filename (reference datasets.py:60-136)."""

    def __init__(self, cfg: Butterflies, *, img_transform=None,
                 mask_transform=None, sample_transform=None):
        self.cfg = cfg
        self.seg_cfg = core_datasets.ImgSegFolder(
            root=pathlib.Path(cfg.root), split=cfg.split, bg_label=0
        )
        self.ds = core_datasets.ImgSegFolderDataset(
            self.seg_cfg, img_transform=img_transform,
            mask_transform=mask_transform, sample_transform=sample_transform,
        )

        meta_fpath = pathlib.Path(cfg.root) / cfg.metadata_csv
        with open(meta_fpath, newline="") as fd:
            rows = list(csv.DictReader(fd))
        if not rows or "Image_name" not in rows[0]:
            raise ValueError(f"{meta_fpath} must have an Image_name column.")
        self.metadata = [
            {k: v for k, v in row.items() if k not in DEAD_COLS} for row in rows
        ]
        by_name = {row["Image_name"]: i for i, row in enumerate(self.metadata)}

        self.index_to_meta: list[int] = []
        for fpath in self.ds.img_fpaths:
            name = pathlib.Path(fpath).name
            meta_idx = by_name.get(name)
            if meta_idx is None:
                raise ValueError(f"No metadata found for image: {name}")
            self.index_to_meta.append(meta_idx)

    def get_metadata(self, index: int) -> dict:
        return dict(self.metadata[self.index_to_meta[index]])

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, index: int) -> dict:
        sample = self.ds[index]
        sample.update(self.get_metadata(index))
        return sample


def get_dataset(cfg: Config, **kwargs) -> MetadataDataset:
    """Factory (reference datasets.py:41-58)."""
    if isinstance(cfg, Butterflies):
        return ButterfliesDataset(cfg, **kwargs)
    tp.assert_never(cfg)
