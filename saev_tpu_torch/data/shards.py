"""Shard protocol: reading and writing sharded ViT activations on disk (a copy
of saev_tpu/data/shards.py's protocol: `Metadata`, `Shard`, `ShardInfo`,
`LabelsWriter`, `ShardWriter`, `pixel_to_patch_labels`, the global index map
`Index`/`IndexMap`, and the dataset config's encoding in `Metadata.data`).

Pure numpy, byte-compatible with the JAX package's and the reference's protocol
(reference `src/saev/data/shards.py`, docs/src/developers/protocol.md):

- A shard directory `.../saev/shards/<hash>/` holds `metadata.json`, `shards.json`,
  `acts{NNNNNN}.bin` float32 memmaps of shape
  (examples_per_shard, n_layers, tokens_per_example, d_model), and optionally
  `labels.bin` (uint8, (n_examples, content_tokens_per_example)).
- `<hash>` is the first 8 hex chars of SHA-256 of the compact JSON of the
  metadata (reference shards.py:127-135), the same bytes as the JAX package's.
- Token axis order: special (CLS) token at index 0 when present, then content tokens.
- `Metadata.data` is the base64 pickle of the dataset config. The port writes
  the JAX package's bytes: its configs pickle under the module name
  `saev_tpu.data.datasets` (`encode_dataset_cfg`), so one extraction gets one
  directory name from either package and either package's restricted
  unpickler reads the other's metadata.
"""

import base64
import dataclasses
import enum
import hashlib
import io
import json
import logging
import math
import os
import pathlib
import pickle
import stat
import typing as tp

import numpy as np

from .. import disk, helpers

logger = logging.getLogger(__name__)

FAMILIES = (
    "bird-mae",
    "clip",
    "dinov2",
    "dinov3",
    "fake-clip",
    "pe-core",
    "pe-spatial",
    "siglip",
)


class PixelAgg(enum.Enum):
    """How to aggregate pixel-level segmentation labels to token-level labels."""

    MAJORITY = "majority"
    PREFER_FG = "prefer-fg"


@dataclasses.dataclass(frozen=True, kw_only=True)
class Metadata:
    """Metadata for a sharded set of transformer activations.

    Mirrors reference shards.py:44-186.

    Args:
        family: The transformer family.
        ckpt: The transformer checkpoint.
        layers: Which layers were saved.
        content_tokens_per_example: The number of content tokens per example.
        cls_token: Whether the transformer has a [CLS] token as well.
        d_model: Model hidden dimension.
        n_examples: Number of examples.
        max_tokens_per_shard: The maximum number of tokens per shard.
        data: base64-encoded string of pickle.dumps(dataset config).
        dataset: Absolute path to the root directory of the original dataset.
        pixel_agg: (seg datasets only) pixel→token label aggregation method.
        dtype: How activations are stored.
        protocol: Protocol version.
    """

    family: str
    ckpt: str
    layers: tuple[int, ...]
    content_tokens_per_example: int
    cls_token: bool
    d_model: int
    n_examples: int
    max_tokens_per_shard: int
    data: str
    dataset: pathlib.Path
    pixel_agg: PixelAgg = PixelAgg.MAJORITY
    dtype: str = "float32"
    protocol: str = "2.1"

    def __post_init__(self):
        assert self.family in FAMILIES, f"Unknown family '{self.family}'."
        assert self.dtype == "float32", "Only float32 shards are supported."
        msg = "At least one example per shard must fit; increase max_tokens_per_shard."
        assert self.examples_per_shard >= 1, msg
        try:
            helpers.jdumps(self.data)
        except TypeError as err:
            raise TypeError("self.data has an unhashable object") from err

    @classmethod
    def load(cls, shards_dir: pathlib.Path) -> "Metadata":
        """Load a Metadata object from metadata.json in shards_dir."""
        shards_dir = pathlib.Path(shards_dir)
        assert disk.is_shards_dir(shards_dir), (
            f"Invalid shards dir '{shards_dir}'. Expected .../saev/shards/<hash>."
        )
        with open(shards_dir / "metadata.json") as fd:
            dct = json.load(fd)
        dct["layers"] = tuple(dct.pop("layers"))
        dct["dataset"] = pathlib.Path(dct["dataset"])
        dct["pixel_agg"] = PixelAgg(dct["pixel_agg"])
        return cls(**dct)

    def dump(self, shards_root: pathlib.Path):
        """Dump this Metadata to metadata.json under shards_root / hash."""
        shards_root = pathlib.Path(shards_root)
        assert disk.is_shards_root(shards_root), (
            f"Invalid shards root '{shards_root}'. Expected .../saev/shards."
        )
        (shards_root / self.hash).mkdir(exist_ok=True)
        with open(shards_root / self.hash / "metadata.json", "wb") as fd:
            helpers.jdump(self, fd, indent=2)

    @property
    def hash(self) -> str:
        """First 8 hex chars of SHA-256 of the compact JSON of this config.

        The reference hashes orjson's dataclass serialization
        (shards.py:127-135, option=OPT_SORT_KEYS). orjson serializes dataclass
        instances in FIELD-DEFINITION order — OPT_SORT_KEYS only affects dicts —
        with compact separators and repr-shortest floats, which the stdlib-json
        rendering below reproduces, keeping shard directory names compatible
        across implementations.
        """
        dct = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        cfg_bytes = helpers.jdumps(dct, sort_keys=False)
        return hashlib.sha256(cfg_bytes).hexdigest()[:8]

    @property
    def tokens_per_example(self) -> int:
        """Total tokens per example including the [CLS] token if present."""
        return self.content_tokens_per_example + int(self.cls_token)

    @property
    def n_shards(self) -> int:
        """Total number of shards needed to store all examples."""
        return math.ceil(self.n_examples / self.examples_per_shard)

    @property
    def examples_per_shard(self) -> int:
        """Number of examples per shard (protocol sizing math, protocol.md:85)."""
        return self.max_tokens_per_shard // (
            self.tokens_per_example * len(self.layers)
        )

    @property
    def shard_shape(self) -> tuple[int, int, int, int]:
        """(examples_per_shard, n_layers, tokens_per_example, d_model)."""
        return (
            self.examples_per_shard,
            len(self.layers),
            self.tokens_per_example,
            self.d_model,
        )

    def make_data_cfg(self):
        """The dataset config that `data` encodes (a `datasets.DatasetConfig`)."""
        from . import datasets

        cfg = decode_dataset_cfg(self.data)
        assert isinstance(cfg, datasets.DatasetConfig)
        return cfg


@dataclasses.dataclass(frozen=True)
class Shard:
    """A single shard entry in shards.json: filename and number of examples."""

    name: str
    n_examples: int


def get_missing_shards_json_msg(
    shards_dir_dpath: pathlib.Path, shards_json_fpath: pathlib.Path
) -> str:
    """Operator-grade diagnostics for a missing shards.json (reference shards.py:546-590)."""
    abs_shards_dir = shards_dir_dpath.resolve(strict=False)
    abs_shards_json = shards_json_fpath.resolve(strict=False)

    lines = [f"Could not load shard metadata at '{abs_shards_json}'."]

    if not shards_dir_dpath.exists():
        lines.append(f"Shard directory is missing: '{abs_shards_dir}'.")
        lines.append(
            "Scratch shards may have been cleaned. Re-run extraction to regenerate shards."
        )
        return "\n".join(lines)

    if not shards_dir_dpath.is_dir():
        lines.append(
            f"Expected shard directory at '{abs_shards_dir}', but it is not a directory."
        )
        return "\n".join(lines)

    metadata_fpath = shards_dir_dpath / "metadata.json"
    labels_fpath = shards_dir_dpath / "labels.bin"
    acts_fpaths = sorted(shards_dir_dpath.glob("acts*.bin"))
    n_acts = len(acts_fpaths)

    lines.append(f"Shard directory exists: '{abs_shards_dir}'.")
    lines.append(f"metadata.json exists: {metadata_fpath.exists()}.")
    lines.append(f"labels.bin exists: {labels_fpath.exists()}.")
    lines.append(f"acts*.bin files found: {n_acts}.")

    if n_acts:
        acts_preview = ", ".join(fpath.name for fpath in acts_fpaths[:5])
        suffix = "" if n_acts <= 5 else ", ..."
        lines.append(f"Example shard files: {acts_preview}{suffix}")
        lines.append(
            "This looks like an incomplete or older shard layout without shards.json. "
            "Re-run extraction to regenerate shards."
        )
        return "\n".join(lines)

    lines.append(
        "No shard binaries were found. This shard directory may be partially deleted "
        "or never fully written."
    )
    lines.append("Re-run extraction to regenerate shards.")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Container for shard manifest entries as recorded in shards.json."""

    shards: list[Shard] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, shards_dir: pathlib.Path) -> "ShardInfo":
        shards_dir = pathlib.Path(shards_dir)
        msg = f"Invalid shards path '{shards_dir}'. Expected .../saev/shards/<hash>."
        assert len(shards_dir.parts) >= 3, msg
        assert shards_dir.parts[-3:-1] == ("saev", "shards"), msg

        shards_json_fpath = shards_dir / "shards.json"
        try:
            with open(shards_json_fpath) as fd:
                data = json.load(fd)
        except FileNotFoundError as err:
            msg = get_missing_shards_json_msg(shards_dir, shards_json_fpath)
            raise FileNotFoundError(msg) from err

        return cls([Shard(**entry) for entry in data])

    def dump(self, shards_dir: pathlib.Path) -> None:
        assert disk.is_shards_dir(pathlib.Path(shards_dir))
        with open(pathlib.Path(shards_dir) / "shards.json", "wb") as fd:
            helpers.jdump(self.shards, fd, indent=2)

    def append(self, shard: Shard):
        self.shards.append(shard)

    def __len__(self) -> int:
        return len(self.shards)

    def __getitem__(self, i):
        return self.shards[i]

    def __iter__(self):
        yield from self.shards

    def validate(self, shards_dir: pathlib.Path | str) -> None:
        """Check that every shard file exists, is non-empty, and is a regular file.

        Mirrors reference shards.py:638-694.
        """
        shards_dir = pathlib.Path(shards_dir)
        assert disk.is_shards_dir(shards_dir)

        missing: list[str] = []
        empty: list[str] = []
        unreadable: list[str] = []
        not_file: list[str] = []

        for shard in self.shards:
            shard_fpath = shards_dir / shard.name
            abs_fpath = str(shard_fpath.resolve())
            try:
                st = shard_fpath.stat()
            except FileNotFoundError:
                missing.append(abs_fpath)
                continue
            except (PermissionError, OSError):
                unreadable.append(abs_fpath)
                continue

            if not stat.S_ISREG(st.st_mode):
                not_file.append(abs_fpath)
                continue
            if st.st_size == 0:
                empty.append(abs_fpath)

        if not (missing or empty or unreadable or not_file):
            return

        lines = [f"Shard validation failed in '{shards_dir.resolve()}':", ""]
        for label, fpaths in (
            ("Missing files", missing),
            ("Empty files", empty),
            ("Unreadable files", unreadable),
            ("Not regular files", not_file),
        ):
            if fpaths:
                lines.append(f"{label} ({len(fpaths)}):")
                lines.extend(f"  - {fpath}" for fpath in fpaths)
                lines.append("")
        if lines[-1] == "":
            lines.pop()
        raise FileNotFoundError("\n".join(lines))


class LabelsWriter:
    """Writes per-patch uint8 segmentation labels to a single labels.bin memmap.

    Mirrors reference shards.py:306-368.
    """

    def __init__(self, shards_dir: pathlib.Path, md: Metadata):
        assert disk.is_shards_dir(pathlib.Path(shards_dir))
        self.logger = logging.getLogger("labels-writer")
        self.md = md
        self.has_written = False

        # Always create the memmap; deleted in ShardWriter.__exit__ if never written.
        self.labels_path = pathlib.Path(shards_dir) / "labels.bin"
        self.labels = np.memmap(
            self.labels_path,
            mode="w+",
            dtype=np.uint8,
            shape=(self.md.n_examples, self.md.content_tokens_per_example),
        )
        self.logger.info("Opened labels file '%s'.", self.labels_path)

    def write_batch(self, batch_labels: np.ndarray, start_idx: int):
        """Write a batch of labels at a global example offset."""
        batch_labels = np.asarray(batch_labels, dtype=np.uint8)
        batch_size = len(batch_labels)
        assert start_idx + batch_size <= self.md.n_examples
        assert batch_labels.shape == (batch_size, self.md.content_tokens_per_example)
        self.labels[start_idx : start_idx + batch_size] = batch_labels
        self.has_written = True

    def flush(self) -> None:
        if self.has_written:
            self.labels.flush()
            self.logger.info("Flushed labels to '%s'.", self.labels_path)


class ShardWriter:
    """Stateful sharded activation writer backed by float32 memmaps.

    Opens `acts{NNNNNN}.bin` files of `md.shard_shape`, fills batches with
    shard-boundary splitting, and records each flushed shard in shards.json.
    Mirrors reference shards.py:372-527.
    """

    def __init__(self, shards_root: pathlib.Path, md: Metadata):
        shards_root = pathlib.Path(shards_root)
        assert disk.is_shards_root(shards_root)
        self.md = md
        self.logger = logging.getLogger("shard-writer")

        self.shards_dir = shards_root / md.hash
        self.shards_dir.mkdir(exist_ok=True)

        self._shards = ShardInfo()
        self.labels_writer = LabelsWriter(self.shards_dir, md)

        self.shard = -1
        self.acts: np.memmap | None = None
        self.filled = 0
        self.next_shard()

    def write_batch(
        self,
        activations: np.ndarray,
        start_idx: int,
        patch_labels: np.ndarray | None = None,
    ) -> None:
        """Write a batch of activations (and optional patch labels), splitting across
        shard boundaries recursively.
        """
        activations = np.asarray(activations, dtype=np.float32)
        batch_size = len(activations)
        end_idx = start_idx + batch_size
        offset = self.md.examples_per_shard * self.shard

        if end_idx > offset + self.md.examples_per_shard:
            # Shard is about to fill: write what fits, roll to the next shard.
            n_fit = offset + self.md.examples_per_shard - start_idx
            self.acts[start_idx - offset : start_idx - offset + n_fit] = activations[
                :n_fit
            ]
            self.filled = start_idx - offset + n_fit

            if patch_labels is not None:
                self.labels_writer.write_batch(
                    np.asarray(patch_labels[:n_fit], dtype=np.uint8), start_idx
                )

            self.next_shard()

            if n_fit < batch_size:
                self.write_batch(
                    activations[n_fit:],
                    start_idx + n_fit,
                    patch_labels[n_fit:] if patch_labels is not None else None,
                )
        else:
            assert 0 <= start_idx - offset <= self.md.examples_per_shard
            assert 0 <= end_idx - offset <= self.md.examples_per_shard
            self.acts[start_idx - offset : end_idx - offset] = activations
            self.filled = end_idx - offset

            if patch_labels is not None:
                self.labels_writer.write_batch(
                    np.asarray(patch_labels, dtype=np.uint8), start_idx
                )

    def flush(self) -> None:
        if self.acts is not None:
            self.acts.flush()
            self._shards.append(
                Shard(name=os.path.basename(self.acts_path), n_examples=self.filled)
            )
            self._shards.dump(self.shards_dir)
        self.acts = None
        self.labels_writer.flush()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.flush()
        if not self.labels_writer.has_written:
            if os.path.exists(self.labels_writer.labels_path):
                os.remove(self.labels_writer.labels_path)
                self.logger.info(
                    "Removed empty labels file '%s'.", self.labels_writer.labels_path
                )

    def next_shard(self) -> None:
        self.flush()
        self.shard += 1
        self.acts_path = self.shards_dir / f"acts{self.shard:06}.bin"
        self.acts = np.memmap(
            self.acts_path, mode="w+", dtype=np.float32, shape=self.md.shard_shape
        )
        self.filled = 0
        self.logger.info("Opened shard '%s'.", self.acts_path)


def pixel_to_patch_labels(
    seg: np.ndarray,
    n_patches: int,
    patch_size: int,
    pixel_agg: PixelAgg = PixelAgg.MAJORITY,
    bg_label: int = 0,
    max_classes: int = 256,
) -> np.ndarray:
    """Convert a pixel-level segmentation mask to patch-level labels (vectorized numpy).

    Mirrors reference shards.py:894-961 (torch bincount approach), as
    saev_tpu/data/shards.py:462 does.

    Args:
        seg: (H, W) uint8 segmentation mask (numpy array or PIL Image convertible).
        n_patches: Total number of patches expected.
        patch_size: Patch side length in pixels.
        pixel_agg: MAJORITY (most common label) or PREFER_FG (most common non-bg label).
        bg_label: Background label index.
        max_classes: Maximum number of classes (bincount width).

    Returns:
        (n_patches,) uint8 patch labels.
    """
    seg = np.asarray(seg, dtype=np.uint8)
    assert seg.ndim == 2

    h, w = seg.shape
    patch_grid_h = h // patch_size
    patch_grid_w = w // patch_size
    assert patch_grid_w * patch_grid_h == n_patches, (
        f"Image size {w}x{h} with patch_size {patch_size} gives "
        f"{patch_grid_w}x{patch_grid_h} = {patch_grid_w * patch_grid_h} patches, "
        f"expected {n_patches}"
    )

    # (h p1) (w p2) -> (h w) (p1 p2)
    patches = (
        seg.reshape(patch_grid_h, patch_size, patch_grid_w, patch_size)
        .transpose(0, 2, 1, 3)
        .reshape(n_patches, patch_size * patch_size)
    )

    offsets = np.arange(n_patches, dtype=np.int64)[:, None] * max_classes
    flat = (patches.astype(np.int64) + offsets).reshape(-1)
    counts = np.bincount(flat, minlength=n_patches * max_classes).reshape(
        n_patches, max_classes
    )

    if pixel_agg is PixelAgg.MAJORITY:
        patch_labels = counts.argmax(axis=1)
    elif pixel_agg is PixelAgg.PREFER_FG:
        nonbg = counts.copy()
        nonbg[:, bg_label] = 0
        has_nonbg = nonbg.sum(axis=1) > 0
        patch_labels = np.where(has_nonbg, nonbg.argmax(axis=1), bg_label)
    else:
        tp.assert_never(pixel_agg)

    return patch_labels.astype(np.uint8)


# The module name the dataset configs pickle under: the JAX package's, so the
# bytes (and so the shard directory's hash) do not depend on which package
# wrote them.
CONFIG_MODULE = "saev_tpu.data.datasets"


@dataclasses.dataclass(frozen=True, kw_only=True)
class Index:
    """Coordinates of one activation vector inside the shard layout.

    Attributes:
        idx: The global index of the activation.
        example_idx: The index of the original example.
        content_token_idx: The token's index within the example's content; -1 for
            special tokens.
        shard_idx: The shard index.
        example_idx_in_shard: Example index along the examples axis of the shard.
        layer_idx_in_shard: Layer index along the layers axis of the shard.
        token_idx_in_shard: Token index along the tokens axis of the shard.
    """

    idx: int
    example_idx: int
    content_token_idx: int
    shard_idx: int
    example_idx_in_shard: int
    layer_idx_in_shard: int
    token_idx_in_shard: int


class IndexMap:
    """Global-index → shard-coordinate math for a (tokens, layer) view of a shard set.

    Mirrors reference shards.py:987-1104 (saev_tpu/data/shards.py `IndexMap`).

    Attributes:
        md: Metadata.
        tokens: Which subset of tokens ('special', 'content', 'all').
        layer: Which layer (int or 'all').
        layer_idx_lookup: transformer layer → layer idx in the shard.
    """

    def __init__(
        self,
        md: Metadata,
        tokens: str,
        layer: int | str,
    ):
        assert tokens in ("special", "content", "all")
        if tokens == "special":
            assert md.cls_token

        self.md = md
        self.tokens = tokens
        self.layer = layer

        if isinstance(layer, int):
            err_msg = f"No match for layer; {layer} not in {md.layers}."
            assert layer in md.layers, err_msg

        self.layer_idx_lookup = {layer: i for i, layer in enumerate(md.layers)}

    def from_global(self, idx: int | np.integer) -> Index:
        idx = int(idx)
        if idx < 0 or idx >= len(self):
            raise IndexError(
                f"Index {idx} out of range for dataset of length {len(self)}"
            )

        match (self.tokens, self.layer):
            case ("special", int()):
                return Index(
                    idx=idx,
                    example_idx=idx,
                    content_token_idx=-1,
                    shard_idx=idx // self.md.examples_per_shard,
                    example_idx_in_shard=idx % self.md.examples_per_shard,
                    layer_idx_in_shard=self.layer_idx_lookup[self.layer],
                    token_idx_in_shard=0,
                )
            case ("content", int()):
                ctpe = self.md.content_tokens_per_example
                per_shard = self.md.examples_per_shard * ctpe
                return Index(
                    idx=idx,
                    example_idx=idx // ctpe,
                    content_token_idx=idx % ctpe,
                    shard_idx=idx // per_shard,
                    example_idx_in_shard=idx % per_shard // ctpe,
                    layer_idx_in_shard=self.layer_idx_lookup[self.layer],
                    token_idx_in_shard=idx % per_shard % ctpe + self.md.cls_token,
                )
            case ("all", int()):
                tpe = self.md.tokens_per_example
                per_shard = self.md.examples_per_shard * tpe
                token_idx_in_shard = idx % per_shard % tpe
                content_token_idx = (
                    token_idx_in_shard - 1 if self.md.cls_token else token_idx_in_shard
                )
                if self.md.cls_token and token_idx_in_shard == 0:
                    content_token_idx = -1
                return Index(
                    idx=idx,
                    example_idx=idx // tpe,
                    content_token_idx=content_token_idx,
                    shard_idx=idx // per_shard,
                    example_idx_in_shard=idx % per_shard // tpe,
                    layer_idx_in_shard=self.layer_idx_lookup[self.layer],
                    token_idx_in_shard=token_idx_in_shard,
                )
            case _:
                raise NotImplementedError(
                    f"from_global not supported for tokens={self.tokens!r}, "
                    f"layer={self.layer!r}."
                )

    def __len__(self) -> int:
        match (self.tokens, self.layer):
            case ("special", "all"):
                return self.md.n_examples * len(self.md.layers)
            case ("special", int()):
                return self.md.n_examples
            case ("content", int()):
                return self.md.n_examples * self.md.content_tokens_per_example
            case ("content", "all"):
                return (
                    self.md.n_examples
                    * len(self.md.layers)
                    * self.md.content_tokens_per_example
                )
            case ("all", int()):
                return self.md.n_examples * self.md.tokens_per_example
            case ("all", "all"):
                return (
                    self.md.n_examples
                    * len(self.md.layers)
                    * self.md.tokens_per_example
                )
            case _:
                raise ValueError(f"Invalid (tokens, layer): {self.tokens}, {self.layer}")


class _ConfigPickler(pickle._Pickler):
    """pickle's own Python pickler, except that the port's dataset-config
    classes are written as `CONFIG_MODULE.<name>`. pickle names a class by
    importing its module to check the name, and importing
    `saev_tpu.data.datasets` would load the JAX package, so those globals are
    written here instead. Everything else (the dataclass's state, its pathlib
    fields, framing and memo) takes pickle's path, with the C pickler's bytes."""

    def save_global(self, obj, name=None):
        from . import datasets

        if isinstance(obj, type) and obj.__module__ == datasets.__name__:
            assert self.proto >= 4, self.proto
            self.save(CONFIG_MODULE)
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def encode_dataset_cfg(data) -> str:
    """Base64-pickle a dataset config for storage in Metadata.data
    (saev_tpu/data/shards.py:659), byte for byte the JAX package's."""
    buf = io.BytesIO()
    _ConfigPickler(buf, pickle.DEFAULT_PROTOCOL).dump(data)
    return base64.b64encode(buf.getvalue()).decode("utf8")


class _SafeConfigUnpickler(pickle.Unpickler):
    """Restricted unpickler for the protocol's base64-pickled dataset configs
    (saev_tpu/data/shards.py:664-698).

    A plain pickle.loads on a shard dir from an untrusted source is arbitrary
    code execution. This unpickler only resolves dataset-config dataclasses,
    the PixelAgg enum, and pathlib path types; everything else raises. Configs
    written by the JAX package (`saev_tpu.data.datasets`), by this package
    (`saev_tpu_torch.data.datasets`) and by the reference
    (`saev.data.datasets`) map onto this package's dataclasses of the same
    name.
    """

    _PATH_NAMES = frozenset(
        {"Path", "PosixPath", "PurePosixPath", "WindowsPath", "PureWindowsPath"}
    )
    _CONFIG_MODULES = frozenset(
        {CONFIG_MODULE, "saev_tpu_torch.data.datasets", "saev.data.datasets", "saev.config"}
    )
    _ENUM_MODULES = frozenset(
        {"saev_tpu.data.shards", "saev_tpu_torch.data.shards", "saev.data.shards"}
    )

    def find_class(self, module, name):
        if module in self._CONFIG_MODULES:
            from . import datasets

            obj = getattr(datasets, name, None)
            if obj is not None and isinstance(obj, type) and dataclasses.is_dataclass(obj):
                return obj
        if module in self._ENUM_MODULES and name == "PixelAgg":
            return PixelAgg
        if module == "pathlib" and name in self._PATH_NAMES:
            return getattr(pathlib, name)
        raise pickle.UnpicklingError(
            f"Blocked unpickling of {module}.{name}: dataset-config metadata "
            "may only contain dataset dataclasses, PixelAgg, and paths."
        )


def decode_dataset_cfg(b64: str):
    """Decode a base64-pickled dataset config with the restricted unpickler
    (saev_tpu/data/shards.py:701)."""
    return _SafeConfigUnpickler(io.BytesIO(base64.b64decode(b64.encode("utf8")))).load()
