"""Dataset configs + map-style datasets for activation extraction (the
counterpart of saev_tpu/data/datasets.py).

Datasets are plain objects with `__len__`/`__getitem__` returning dict
samples `{data, index, target, label[, patch_labels]}`. Mirrors the reference's
`src/saev/data/datasets.py:19-755` config/sample contract.

The module imports without Pillow, pandas or HuggingFace `datasets`: the
image datasets import Pillow when they make or open an image, HuggingFace
`datasets` is imported by the configs and the dataset that read it, and
BirdCLEF's CSVs are read with the stdlib `csv` module, their label columns
typed as pandas' `read_csv` types them (`_pandas_strings`), so the labels and
the sample order are the JAX package's. The configs pickle under the JAX
package's module name (`shards.encode_dataset_cfg`).
"""

import abc
import csv
import dataclasses
import glob
import logging
import os
import pathlib
import typing as tp
from collections.abc import Callable

import numpy as np

logger = logging.getLogger(__name__)

IMG_EXTENSIONS = (
    ".jpg",
    ".jpeg",
    ".png",
    ".ppm",
    ".bmp",
    ".pgm",
    ".tif",
    ".tiff",
    ".webp",
)


class DatasetConfig(abc.ABC):
    """Abstract base class for dataset configurations."""

    @property
    @abc.abstractmethod
    def n_examples(self) -> int:
        """Number of examples in the dataset."""

    @property
    @abc.abstractmethod
    def root(self) -> pathlib.Path:
        """Root directory path for the dataset."""


@dataclasses.dataclass(frozen=True)
class Imagenet(DatasetConfig):
    """Configuration for HuggingFace ImageNet."""

    name: str = "ILSVRC/imagenet-1k"
    """Dataset name on HuggingFace."""
    split: str = "train"
    """Dataset split: 'train', 'validation' or 'test'."""

    @property
    def n_examples(self) -> int:
        import datasets

        return len(datasets.load_dataset(self.name, split=self.split))

    @property
    def root(self) -> pathlib.Path:
        return pathlib.Path(self.name)


@dataclasses.dataclass(frozen=True)
class Cifar10(DatasetConfig):
    """Configuration for HuggingFace CIFAR-10."""

    name: str = "uoft-cs/cifar10"
    split: str = "train"

    @property
    def n_examples(self) -> int:
        import datasets

        return len(datasets.load_dataset(self.name, split=self.split))

    @property
    def root(self) -> pathlib.Path:
        return pathlib.Path(self.name)


@dataclasses.dataclass(frozen=True)
class ImgFolder(DatasetConfig):
    """Generic image-folder dataset (torchvision ImageFolder layout).

    Layout: root/classN/img.png. `root` may be a glob pattern matching several roots.
    """

    root: pathlib.Path = pathlib.Path("./data/split")

    @property
    def n_examples(self) -> int:
        # Must agree exactly with get_dataset's construction (glob.glob over
        # the pattern, then images under class subdirectories only) — the
        # count is written into shard Metadata and asserted against the real
        # stream during extraction.
        import glob as glob_mod

        n = 0
        for root in glob_mod.glob(str(self.root), recursive=True):
            root = pathlib.Path(root)
            if not root.is_dir():
                continue
            for cls_dir in root.iterdir():
                if not cls_dir.is_dir():
                    continue
                for _, _, files in os.walk(cls_dir):
                    n += sum(1 for f in files if f.lower().endswith(IMG_EXTENSIONS))
        return n


@dataclasses.dataclass(frozen=True)
class ImgSegFolder(DatasetConfig):
    """Image segmentation folder: root/{images,annotations}/<split>/ + labels csv."""

    root: pathlib.Path = pathlib.Path("./data/segdataset")
    split: str = "training"
    labels_csv: str = "labels.csv"
    """CSV file with columns: stem,label1,label2,... First column must be 'stem'."""
    bg_label: int = 0
    """Background label."""

    @property
    def n_examples(self) -> int:
        img_dir = self.root / "images" / self.split
        if not img_dir.is_dir():
            return 0
        n = 0
        for _, _, files in os.walk(img_dir):
            n += sum(1 for f in files if f.lower().endswith(IMG_EXTENSIONS))
        return n


@dataclasses.dataclass(frozen=True)
class FakeImg(DatasetConfig):
    """Synthetic image dataset for fast hermetic tests."""

    n_examples: int = 10

    @property
    def root(self) -> pathlib.Path:
        return pathlib.Path("fake")


@dataclasses.dataclass(frozen=True)
class FakeImgSeg(DatasetConfig):
    """Tiny synthetic segmentation dataset for tests.

    Generates dummy RGB images and deterministic pixel-level segmentation masks.
    """

    n_examples: int = 10
    content_tokens_per_example: int = 16
    n_classes: int = 3
    bg_label: int = 0

    @property
    def root(self) -> pathlib.Path:
        return pathlib.Path("fake-seg")


@dataclasses.dataclass(frozen=True)
class BirdClef2025(DatasetConfig):
    """BirdCLEF 2025 audio dataset, filtered to bird species (Aves)."""

    root: pathlib.Path = pathlib.Path("data/birdclef-2025")
    split: str = "train_audio"

    @property
    def n_examples(self) -> int:
        bird_labels = set(_bird_labels(self.root / "taxonomy.csv"))

        if self.split == "train_audio":
            train = _read_csv(self.root / "train.csv")
            return sum(label in bird_labels for label in _pandas_strings(train["primary_label"]))
        elif self.split in ("train_soundscapes", "test_soundscapes"):
            dpath = self.root / self.split
            return sum(1 for f in dpath.iterdir() if f.suffix == ".ogg")
        else:
            tp.assert_never(self.split)


# ---------------------------------------------------------------------------
# BirdCLEF's CSVs without pandas
# ---------------------------------------------------------------------------

# pandas.read_csv's default missing-value strings.
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})


def _read_csv(fpath: pathlib.Path) -> dict[str, list[str]]:
    """A CSV file's columns by header name, each a list of its raw cells."""
    with open(fpath, newline="") as fd:
        reader = csv.reader(fd)
        header = next(reader)
        cols: dict[str, list[str]] = {name: [] for name in header}
        for row in reader:
            if not row:
                continue  # pandas skips blank lines
            for name, cell in zip(header, row + [""] * (len(header) - len(row))):
                cols[name].append(cell)
    return cols


def _parses(cast, cell: str) -> bool:
    if "_" in cell:
        return False  # Python's literals take "1_000"; pandas does not
    try:
        cast(cell)
    except ValueError:
        return False
    return True


def _pandas_strings(cells: list[str]) -> list[str]:
    """What `pd.read_csv(...)[col].astype(str)` gives for a column of raw
    cells: all integers → int64 ("007" → "7"); all numbers, or integers with
    missing cells → float64 ("3" → "3.0", missing → "nan"); all booleans →
    "True"/"False"; otherwise the cells as written, missing ones "nan"."""
    present = [c for c in cells if c not in _NA_VALUES]
    if present and len(present) == len(cells) and all(_parses(int, c) for c in present):
        return [str(int(c)) for c in cells]
    if present and all(_parses(float, c) for c in present):
        return ["nan" if c in _NA_VALUES else str(float(c)) for c in cells]
    if present and all(c in _TRUE | _FALSE for c in present):
        return ["nan" if c in _NA_VALUES else str(c in _TRUE) for c in cells]
    return ["nan" if c in _NA_VALUES else c for c in cells]


def _bird_labels(taxonomy_fpath: pathlib.Path) -> list[str]:
    """The `primary_label`s of taxonomy rows whose `class_name` is "Aves",
    in file order, as pandas' `.astype(str)` renders them."""
    tax = _read_csv(taxonomy_fpath)
    labels = _pandas_strings(tax["primary_label"])
    return [label for label, cls in zip(labels, tax["class_name"]) if cls == "Aves"]


Config = (
    Imagenet | Cifar10 | ImgFolder | ImgSegFolder | FakeImg | FakeImgSeg | BirdClef2025
)


def is_img_seg_dataset(data_cfg: DatasetConfig) -> bool:
    """True if this dataset has pixel segmentation masks (→ labels.bin on disk)."""
    return isinstance(data_cfg, (ImgSegFolder, FakeImgSeg))


class _Dataset:
    """Minimal map-style dataset protocol (torch-free)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int) -> dict[str, object]:
        raise NotImplementedError


class FakeImgDataset(_Dataset):
    def __init__(self, cfg: FakeImg, *, img_transform=None, sample_transform=None):
        self.n_examples = cfg.n_examples
        self.img_transform = img_transform
        self.sample_transform = sample_transform

    def __len__(self):
        return self.n_examples

    def __getitem__(self, i):
        from PIL import Image

        img = Image.new("RGB", (256, 256))
        if self.img_transform is not None:
            img = self.img_transform(img)
        sample = {"data": img, "index": i, "target": 0, "label": "dummy"}
        if self.sample_transform is not None:
            sample = self.sample_transform(sample)
        return sample


class FakeImgSegDataset(_Dataset):
    """Synthetic segmentation dataset with deterministic per-patch labels."""

    def __init__(
        self,
        cfg: FakeImgSeg,
        *,
        img_transform=None,
        mask_transform=None,
        sample_transform=None,
    ):
        self.cfg = cfg
        self.img_transform = img_transform
        self.mask_transform = mask_transform
        self.sample_transform = sample_transform

    def __len__(self) -> int:
        return self.cfg.n_examples

    def __getitem__(self, i: int) -> dict[str, object]:
        from PIL import Image

        img_size = 64
        img = Image.new("RGB", (img_size, img_size), color=(127, 127, 127))

        # Deterministic per-patch mask: label = (patch_idx + i) % n_classes, with the
        # first patch row forced to background.
        seg_array = np.zeros((img_size, img_size), dtype=np.uint8)
        patch_grid_size = int(np.sqrt(self.cfg.content_tokens_per_example))
        patch_size = img_size // patch_grid_size

        for y in range(0, img_size, patch_size):
            for x in range(0, img_size, patch_size):
                patch_idx = (y // patch_size) * patch_grid_size + (x // patch_size)
                label = (patch_idx + i) % self.cfg.n_classes
                seg_array[y : y + patch_size, x : x + patch_size] = label

        if self.cfg.bg_label < self.cfg.n_classes:
            seg_array[:patch_size, :] = self.cfg.bg_label

        segmentation = Image.fromarray(seg_array)

        if self.img_transform is not None:
            img = self.img_transform(img)

        patch_labels = None
        if self.mask_transform is not None:
            patch_labels = self.mask_transform(segmentation)

        sample: dict[str, object] = {
            "data": img,
            "index": i,
            "target": 0,
            "label": "dummy",
        }
        if patch_labels is not None:
            sample["patch_labels"] = patch_labels
        if self.sample_transform is not None:
            sample = self.sample_transform(sample)
        return sample


def _walk_images(root: pathlib.Path) -> list[pathlib.Path]:
    found = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                found.append(pathlib.Path(dirpath) / f)
    return sorted(found)


class ImgFolderDataset(_Dataset):
    """Image-folder dataset: class subdirectories containing images."""

    def __init__(self, root: str | pathlib.Path, *, transform=None, sample_transform=None):
        self.root = pathlib.Path(root)
        self.transform = transform
        self.sample_transform = sample_transform

        self.samples: list[tuple[pathlib.Path, int, str]] = []
        classes = sorted(
            d.name for d in self.root.iterdir() if d.is_dir()
        ) if self.root.is_dir() else []
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for cls_name in classes:
            for fpath in _walk_images(self.root / cls_name):
                self.samples.append((fpath, self.class_to_idx[cls_name], cls_name))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> dict[str, object]:
        from PIL import Image

        fpath, target, label = self.samples[i]
        img = Image.open(fpath).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        sample = {"data": img, "index": i, "target": target, "label": label}
        if self.sample_transform is not None:
            sample = self.sample_transform(sample)
        return sample


class ImgSegFolderDataset(_Dataset):
    """Image segmentation dataset: images/ + annotations/ + labels csv."""

    def __init__(
        self,
        cfg: ImgSegFolder,
        *,
        img_transform=None,
        mask_transform=None,
        sample_transform=None,
    ):
        self.cfg = cfg
        self.img_transform = img_transform
        self.mask_transform = mask_transform
        self.sample_transform = sample_transform

        img_dir = cfg.root / "images" / cfg.split
        self.img_fpaths = _walk_images(img_dir) if img_dir.is_dir() else []

        # All CSV columns are kept: multi-column CSVs define several image-level
        # label spaces at once (e.g. FishVista habitat/diet columns; reference
        # datasets.py:419-422 models this as a per-sample labels dict).
        self.labels: dict[str, str] = {}
        self.label_cols: list[str] = []
        self.sample_labels: dict[str, dict[str, str]] = {}
        labels_fpath = cfg.root / cfg.labels_csv
        if labels_fpath.exists():
            with open(labels_fpath, newline="") as fd:
                reader = csv.reader(fd)
                header = next(reader, None)
                assert header and header[0] == "stem", (
                    f"First column of {labels_fpath} must be 'stem'."
                )
                self.label_cols = list(header[1:])
                for row in reader:
                    self.labels[row[0]] = row[1] if len(row) > 1 else ""
                    self.sample_labels[row[0]] = {
                        col: (row[k + 1] if k + 1 < len(row) else "")
                        for k, col in enumerate(self.label_cols)
                    }

    def __len__(self) -> int:
        return len(self.img_fpaths)

    def _seg_fpath(self, img_fpath: pathlib.Path) -> pathlib.Path:
        ann_dir = self.cfg.root / "annotations" / self.cfg.split
        for ext in (".png", ".tif", ".tiff"):
            cand = ann_dir / (img_fpath.stem + ext)
            if cand.exists():
                return cand
        raise FileNotFoundError(f"No annotation for {img_fpath.stem} in {ann_dir}.")

    def __getitem__(self, i: int) -> dict[str, object]:
        from PIL import Image

        img_fpath = self.img_fpaths[i]
        img = Image.open(img_fpath).convert("RGB")
        segmentation = Image.open(self._seg_fpath(img_fpath))

        if self.img_transform is not None:
            img = self.img_transform(img)

        patch_labels = None
        if self.mask_transform is not None:
            patch_labels = self.mask_transform(segmentation)

        label = self.labels.get(img_fpath.stem, "")
        sample: dict[str, object] = {
            "data": img,
            "index": i,
            "target": 0,
            "label": label,
        }
        if patch_labels is not None:
            sample["patch_labels"] = patch_labels
        if self.sample_transform is not None:
            sample = self.sample_transform(sample)
        return sample


class HfImageDataset(_Dataset):
    """Wraps a HuggingFace image dataset (Imagenet/Cifar10 configs)."""

    def __init__(self, cfg, img_key: str, *, img_transform=None, sample_transform=None):
        import datasets as hf_datasets

        self.hf_dataset = hf_datasets.load_dataset(cfg.name, split=cfg.split)
        self.img_key = img_key
        self.img_transform = img_transform
        self.sample_transform = sample_transform

    def __len__(self) -> int:
        return len(self.hf_dataset)

    def __getitem__(self, i: int) -> dict[str, object]:
        row = self.hf_dataset[i]
        img = row[self.img_key]
        if img.mode != "RGB":
            img = img.convert("RGB")
        if self.img_transform is not None:
            img = self.img_transform(img)
        target = int(row.get("label", 0)) if isinstance(row, dict) else 0
        sample = {"data": img, "index": i, "target": target, "label": str(target)}
        if self.sample_transform is not None:
            sample = self.sample_transform(sample)
        return sample


def _load_audio(fpath: pathlib.Path) -> tuple[np.ndarray, int]:
    """Decode an audio file to (mono float32 waveform, sample_rate).

    Layered backends: soundfile (ogg/flac/wav), torchaudio, the built-in
    ctypes libvorbisfile binding (ogg — present on any distro with the
    vorbis codecs), then scipy (wav only).
    """
    try:
        import soundfile

        wav, sr = soundfile.read(fpath, dtype="float32", always_2d=True)
        return wav.mean(axis=1), int(sr)
    except ImportError:
        pass
    try:
        import torchaudio

        wav, sr = torchaudio.load(str(fpath))
        return wav.numpy().astype(np.float32).mean(axis=0), int(sr)
    except ImportError:
        pass
    if fpath.suffix.lower() in (".ogg", ".oga"):
        from ..utils import vorbis

        if vorbis.available():
            return vorbis.read_ogg(fpath)
    if fpath.suffix.lower() == ".wav":
        import scipy.io.wavfile

        sr, wav = scipy.io.wavfile.read(fpath)
        # Normalize integer PCM (e.g. int16) to [-1, 1] BEFORE the float cast:
        # np.iinfo must see the original dtype.
        if wav.dtype.kind == "u":
            # Unsigned PCM (uint8 WAV) is offset-encoded around the midpoint.
            mid = (int(np.iinfo(wav.dtype).max) + 1) // 2
            wav = (wav.astype(np.float32) - mid) / mid
        elif wav.dtype.kind == "i":
            wav = wav.astype(np.float32) / np.iinfo(wav.dtype).max
        else:
            wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=1)
        return wav.astype(np.float32), int(sr)
    raise ImportError(
        f"No audio decoder available for {fpath.suffix!r} files: install "
        "soundfile/torchaudio or the system vorbis libraries (scipy handles "
        ".wav only)."
    )


class BirdClef2025Dataset(_Dataset):
    """BirdCLEF 2025 audio dataset filtered to bird species (Aves), mirroring
    the reference's BirdClef2025 semantics (reference datasets.py:181,:289-755):
    samples are {data: waveform-or-transformed, index, target, label}."""

    def __init__(self, cfg: BirdClef2025, *, audio_transform=None, sample_transform=None):
        self.cfg = cfg
        self.audio_transform = audio_transform
        self.sample_transform = sample_transform

        bird_labels = sorted(_bird_labels(cfg.root / "taxonomy.csv"))
        self.label_to_idx = {l: i for i, l in enumerate(bird_labels)}

        self.samples: list[tuple[pathlib.Path, int, str]] = []
        if cfg.split == "train_audio":
            train = _read_csv(cfg.root / "train.csv")
            labels = _pandas_strings(train["primary_label"])
            for label, fname in zip(labels, _pandas_strings(train["filename"])):
                if label in self.label_to_idx:
                    self.samples.append(
                        (cfg.root / "train_audio" / fname,
                         self.label_to_idx[label], label)
                    )
        elif cfg.split in ("train_soundscapes", "test_soundscapes"):
            for f in sorted((cfg.root / cfg.split).iterdir()):
                if f.suffix == ".ogg":
                    self.samples.append((f, -1, ""))
        else:
            tp.assert_never(cfg.split)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> dict[str, object]:
        fpath, target, label = self.samples[i]
        wav, sr = _load_audio(fpath)
        data = wav if self.audio_transform is None else self.audio_transform(wav)
        sample = {"data": data, "index": i, "target": target, "label": label,
                  "sample_rate": sr}
        if self.sample_transform is not None:
            sample = self.sample_transform(sample)
        return sample


class ConcatDataset(_Dataset):
    def __init__(self, datasets: list[_Dataset]):
        self.datasets = datasets
        self._cum = np.cumsum([len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._cum[-1]) if len(self.datasets) else 0

    def __getitem__(self, i: int) -> dict[str, object]:
        ds_idx = int(np.searchsorted(self._cum, i, side="right"))
        prev = 0 if ds_idx == 0 else int(self._cum[ds_idx - 1])
        return self.datasets[ds_idx][i - prev]


def get_dataset(
    cfg: Config,
    *,
    data_transform: Callable | None = None,
    mask_transform: Callable | None = None,
    sample_transform: Callable | None = None,
):
    """Build the dataset for a config. Mirrors reference datasets.py:224-288."""
    if isinstance(cfg, Imagenet):
        return HfImageDataset(
            cfg, "image", img_transform=data_transform, sample_transform=sample_transform
        )
    elif isinstance(cfg, Cifar10):
        return HfImageDataset(
            cfg, "img", img_transform=data_transform, sample_transform=sample_transform
        )
    elif isinstance(cfg, ImgSegFolder):
        return ImgSegFolderDataset(
            cfg,
            img_transform=data_transform,
            mask_transform=mask_transform,
            sample_transform=sample_transform,
        )
    elif isinstance(cfg, ImgFolder):
        ds = [
            ImgFolderDataset(
                root, transform=data_transform, sample_transform=sample_transform
            )
            for root in glob.glob(str(cfg.root), recursive=True)
        ]
        if len(ds) == 1:
            return ds[0]
        return ConcatDataset(ds)
    elif isinstance(cfg, FakeImg):
        return FakeImgDataset(
            cfg, img_transform=data_transform, sample_transform=sample_transform
        )
    elif isinstance(cfg, FakeImgSeg):
        return FakeImgSegDataset(
            cfg,
            img_transform=data_transform,
            mask_transform=mask_transform,
            sample_transform=sample_transform,
        )
    elif isinstance(cfg, BirdClef2025):
        return BirdClef2025Dataset(
            cfg, audio_transform=data_transform, sample_transform=sample_transform
        )
    else:
        tp.assert_never(cfg)
