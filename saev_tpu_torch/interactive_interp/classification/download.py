"""Dataset fetchers for the classification probing demos.

Counterpart of contrib/interactive_interp/classification/download.py (host
urllib, no device work). One module with three subcommands, mirroring the
reference's three standalone scripts (reference contrib/interactive_interp/classification/download/
download_flowers.py, download_cub.py, download_caltech101.py): fetch an
archive, extract it, and organize images into the `ImgFolder` layout
(`<split>/<class>/<img>`) the extraction pipeline consumes.

Each command takes URL overrides so the organizing logic is testable offline
with `file://` fixtures (the reference's scripts require live network).

    python -m saev_tpu_torch.interactive_interp.classification.download flowers --dir data/flowers
    python -m saev_tpu_torch.interactive_interp.classification.download cub --dir data/cub
    python -m saev_tpu_torch.interactive_interp.classification.download caltech101 --dir data/caltech
"""

import dataclasses
import logging
import pathlib
import random
import shutil
import tarfile
import urllib.request
import zipfile

logger = logging.getLogger("cls.download")

IMG_EXTS = (".jpg", ".jpeg", ".png")

FLOWERS_IMAGES_URL = "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/102flowers.tgz"
FLOWERS_LABELS_URL = "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/imagelabels.mat"
FLOWERS_SPLITS_URL = "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/setid.mat"
CUB_URL = "https://data.caltech.edu/records/65de6-vp158/files/CUB_200_2011.tgz"
CALTECH_URL = "https://data.caltech.edu/records/mzrjq-6wc02/files/caltech-101.zip"


def fetch(url: str, dst: pathlib.Path, *, chunk_kb: int = 512) -> pathlib.Path:
    """Stream `url` to `dst` (supports file:// for offline fixtures)."""
    dst.parent.mkdir(parents=True, exist_ok=True)
    with urllib.request.urlopen(url) as resp, open(dst, "wb") as fd:
        while chunk := resp.read(chunk_kb * 1024):
            fd.write(chunk)
    logger.info("Downloaded %s -> %s (%d bytes)", url, dst, dst.stat().st_size)
    return dst


# ---------------------------------------------------------------------------
# Flowers102 (reference download_flowers.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Flowers:
    """Oxford Flowers102 -> train/val/test ImgFolder layout."""

    dir: pathlib.Path = pathlib.Path(".")
    images_url: str = FLOWERS_IMAGES_URL
    labels_url: str = FLOWERS_LABELS_URL
    splits_url: str = FLOWERS_SPLITS_URL


def flowers(cfg: Flowers) -> pathlib.Path:
    import scipy.io

    root = pathlib.Path(cfg.dir)
    labels_mat = fetch(cfg.labels_url, root / "imagelabels.mat")
    splits_mat = fetch(cfg.splits_url, root / "setid.mat")
    images_tgz = fetch(cfg.images_url, root / "102flowers.tgz")

    labels = scipy.io.loadmat(labels_mat)["labels"].reshape(-1).tolist()
    mat = scipy.io.loadmat(splits_mat)
    split_ids = {
        "train": set(mat["trnid"].reshape(-1).tolist()),
        "val": set(mat["valid"].reshape(-1).tolist()),
        "test": set(mat["tstid"].reshape(-1).tolist()),
    }
    with tarfile.open(images_tgz, "r") as tar:
        tar.extractall(path=root, filter="data")
    jpg_dir = root / "jpg"

    # One folder per class per split (torchvision ImageFolder layout; the
    # reference documents this at download_flowers.py:105-116).
    for i, label in enumerate(labels):
        idx = i + 1
        split = next((s for s, ids in split_ids.items() if idx in ids), None)
        if split is None:
            raise ValueError(f"Image {idx} not in any split.")
        name = f"image_{idx:05d}.jpg"
        dst = root / split / str(label) / name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(jpg_dir / name, dst)
    shutil.rmtree(jpg_dir, ignore_errors=True)
    n_classes = len(set(labels))
    logger.info("Organized %d images into %d class folders.", len(labels), n_classes)
    return root


# ---------------------------------------------------------------------------
# CUB-200-2011 (reference download_cub.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cub:
    """CUB-200-2011 -> train/test ImgFolder layout from the official split."""

    dir: pathlib.Path = pathlib.Path(".")
    url: str = CUB_URL


def cub(cfg: Cub) -> pathlib.Path:
    root = pathlib.Path(cfg.dir)
    tgz = fetch(cfg.url, root / "CUB_200_2011.tgz")
    with tarfile.open(tgz, "r") as tar:
        tar.extractall(path=root, filter="data")
    ds = root / "CUB_200_2011"

    def pairs(fname: str):
        with open(ds / fname) as fd:
            for line in fd:
                a, b = line.strip().split(" ", 1)
                yield int(a), b

    classes = {i: name for i, name in pairs("classes.txt")}
    image_paths = dict(pairs("images.txt"))
    image_labels = {i: int(v) for i, v in pairs("image_class_labels.txt")}
    image_split = {i: int(v) for i, v in pairs("train_test_split.txt")}

    for img_id, rel in image_paths.items():
        split = "train" if image_split[img_id] == 1 else "test"
        dst = root / split / classes[image_labels[img_id]] / pathlib.Path(rel).name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(ds / "images" / rel, dst)
    logger.info(
        "Organized %d images into %d classes (train/test).",
        len(image_paths), len(classes),
    )
    return root


# ---------------------------------------------------------------------------
# Caltech-101 (reference download_caltech101.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Caltech101:
    """Caltech-101 -> 30-per-class train / up-to-50 test random split."""

    dir: pathlib.Path = pathlib.Path(".")
    url: str = CALTECH_URL
    seed: int = 42
    n_train: int = 30
    n_test: int = 50


def caltech101(cfg: Caltech101) -> pathlib.Path:
    root = pathlib.Path(cfg.dir)
    zip_path = fetch(cfg.url, root / "caltech-101.zip")
    with zipfile.ZipFile(zip_path) as zf:
        zf.extract("caltech-101/101_ObjectCategories.tar.gz", root)
    with tarfile.open(root / "caltech-101" / "101_ObjectCategories.tar.gz") as tar:
        tar.extractall(path=root, filter="data")
    shutil.rmtree(root / "caltech-101")
    dpath = root / "101_ObjectCategories"
    shutil.rmtree(dpath / "BACKGROUND_Google", ignore_errors=True)

    rng = random.Random(cfg.seed)
    n_classes = 0
    for class_dir in sorted(p for p in dpath.iterdir() if p.is_dir()):
        files = sorted(
            f for f in class_dir.iterdir() if f.suffix.lower() in IMG_EXTS
        )
        rng.shuffle(files)
        for split, sel in (
            ("train", files[: cfg.n_train]),
            ("test", files[cfg.n_train : cfg.n_train + cfg.n_test]),
        ):
            out = root / split / class_dir.name
            out.mkdir(parents=True, exist_ok=True)
            for f in sel:
                shutil.copy2(f, out / f.name)
        n_classes += 1
    shutil.rmtree(dpath)
    logger.info("Created train/test split with %d classes.", n_classes)
    return root


if __name__ == "__main__":
    from ...utils import cli as cli_mod

    logging.basicConfig(level=logging.INFO)
    cli_mod.run({"flowers": flowers, "cub": cub, "caltech101": caltech101})
